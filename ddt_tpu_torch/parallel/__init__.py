"""Row-partitioned training over torch.distributed: the process group and
row layout (mesh), the collectives (comms) and a launcher (spawn)."""
