# Fault tolerance and checkpoints of the port (stencil side):
#   fault_tolerance — failure injection, heartbeats, stragglers, reshard_state
#   checkpoint      — atomic CRC-checked checkpoints, the JAX package's format
