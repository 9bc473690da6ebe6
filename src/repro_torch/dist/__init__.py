"""Distribution: the sharding engine (`sharding`: logical axes onto mesh
axes, a rank's local shards) and fault tolerance for the training loop
(`fault`: heartbeat, watchdog, resume)."""
