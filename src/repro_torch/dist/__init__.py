"""Fault tolerance for the training loop (heartbeat, watchdog,
resume); the mesh and the router wait for later slices."""
