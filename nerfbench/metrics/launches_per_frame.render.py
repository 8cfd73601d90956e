"""launches_per_frame.render: device kernels per whole frame in the traced
window."""


def read(w):
    if not w.units or not w.kernels:
        return None
    return len(w.kernels) / w.units
