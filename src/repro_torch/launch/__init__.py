"""Entry points of the port: ``python -m repro_torch.launch.serve``,
``python -m repro_torch.launch.train`` (the LM trainer) and
``python -m repro_torch.launch.mission``; ``launch/steps`` holds the
train, prefill and decode step builders."""
