"""K-Planes decoder-network size sweep
(counterpart of experiments/kplanes_net.py; the sweep: sweeps.DRIVERS)."""
from soccernerfs_tpu_torch.experiments.sweeps import main

if __name__ == "__main__":
    main("kplanes_net")
