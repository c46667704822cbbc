"""Closed-loop aerial SAR mission simulator (port of ``repro/mission``).

  world.py     grid-world map: victims and a spatially correlated
               severity field, rendered on the device
  uav.py       fleet model: sectors, kinematics counters, the
               per-sortie energy/time ledger
  policy.py    lawnmower / information-gain planners and the
               verification router
  rollout.py   device-resident episodes: one host pull per die group
  detector.py  the weather-trained SAR detector

Entry points: ``fly_mission`` (rollout.py) and ``launch/mission.py``.
"""

from repro_torch.mission.detector import trained_detector
from repro_torch.mission.policy import MissionPolicy
from repro_torch.mission.rollout import (MissionResult, fly_mission,
                                         mission_horizon_s,
                                         sar_mission_cost)
from repro_torch.mission.uav import UavConfig, init_fleet, sector_rows
from repro_torch.mission.world import (WorldConfig, make_world,
                                       observe_cells, stack_worlds)

__all__ = [
    "MissionPolicy", "MissionResult", "UavConfig", "WorldConfig",
    "fly_mission", "init_fleet", "make_world", "mission_horizon_s",
    "observe_cells", "sar_mission_cost", "sector_rows", "stack_worlds",
    "trained_detector",
]
