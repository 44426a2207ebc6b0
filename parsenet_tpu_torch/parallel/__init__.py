"""Process groups, sharding and ring collectives (torch.distributed)."""
