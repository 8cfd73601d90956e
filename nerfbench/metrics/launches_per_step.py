"""launches_per_step (launches_per_step.<train cell kind>): device kernels per training step in the traced
window (what a captured graph or a fusion cuts)."""


def read(w):
    if not w.units or not w.kernels:
        return None
    return len(w.kernels) / w.units
