"""Runtime layer of the port: topology, blocked transposes, streamed
exchange rounds and device probes (host topology so far)."""
