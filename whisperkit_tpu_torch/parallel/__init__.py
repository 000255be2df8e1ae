"""More than one device: the dcn x dp x tp mesh (mesh.py), the tp ranks'
collectives (group.py) and Whisper's tensor-parallel parameter split
(sharding.py)."""
