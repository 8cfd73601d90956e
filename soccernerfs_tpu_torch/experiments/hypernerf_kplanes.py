"""K-Planes on HyperNeRF captures, bounded and unbounded
(counterpart of experiments/hypernerf_kplanes.py; the sweep: sweeps.DRIVERS)."""
from soccernerfs_tpu_torch.experiments.sweeps import main

if __name__ == "__main__":
    main("hypernerf_kplanes")
