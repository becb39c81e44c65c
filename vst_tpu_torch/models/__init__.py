"""Model families of the port (slice 1: ReCoNet, SD1, SD2)."""
