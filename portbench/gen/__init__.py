"""Input generators, made on the device from the run's seed. Plain PyTorch:
they import nothing of the port, so a change to the port's transmitter
cannot change what the receiver is fed."""
