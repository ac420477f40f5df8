"""Multi-device execution of the port: one process per device over
torch.distributed (the process group, the (dp, vp) mesh, the sharded
counting ring)."""
