"""Distribution of the port: today the single-device parts, checkpoints
(`checkpoint.py`) and the fault-tolerant driver (`fault_tolerance.py`).
Sharding, compression and the mesh's resources wait for ROADMAP A13."""
