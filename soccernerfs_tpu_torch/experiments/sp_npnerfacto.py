"""NeRFPlayer-nerfacto temporal-dim sweep on StadiumPlayers
(counterpart of experiments/sp_npnerfacto.py; the sweep: sweeps.DRIVERS)."""
from soccernerfs_tpu_torch.experiments.sweeps import main

if __name__ == "__main__":
    main("sp_npnerfacto")
