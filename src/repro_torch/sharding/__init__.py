"""Sharding rules and placement over a device mesh (mirrors
``repro/sharding``)."""

from repro_torch.sharding.specs import (P, PartitionSpec, Placed,
                                        batch_specs, cache_specs, dp_axes,
                                        gather, logits_spec,
                                        opt_state_specs, param_specs, place,
                                        validate_specs)

__all__ = ["P", "PartitionSpec", "Placed", "batch_specs", "cache_specs",
           "dp_axes", "gather", "logits_spec", "opt_state_specs",
           "param_specs", "place", "validate_specs"]
