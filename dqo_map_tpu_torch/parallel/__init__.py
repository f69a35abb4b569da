"""Multi-device mapping: keyframe data parallelism and object sharding
over a list of devices (`dp.py`)."""
