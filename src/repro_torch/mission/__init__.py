"""Mission-side models (mirrors ``repro/mission``): the weather-trained
SAR detector.  The world, UAV, policy and rollout are not ported."""
