"""Model configurations of the port (the simulator's only one so far is the
paper's FlyWire workload)."""
