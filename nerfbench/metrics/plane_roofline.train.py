"""plane_roofline.train: the least time of the traced steps' plane lookups
and their gradients (metrics/work.py: distinct table rows the steps'
sample points touch, coordinates once, features and gradients once, at
3.35 TB/s) over the device time of the kernels that do them, %."""
from nerfbench.metrics import work

KERNELS = ("bilerp_fwd_unpacked_kernel<", "bilerp_fwd_packed_kernel<",
           "bilerp_bwd_kernel<")


def read(w):
    seconds = w.kernel_seconds(lambda n: any(k in n for k in KERNELS))
    if "plane_bytes" not in w.work or seconds <= 0:
        return None
    return work.roofline_share(w.work["plane_bytes"], w.work["plane_flops"], seconds)
