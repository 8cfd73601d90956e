"""fused_roofline.render: the least time of the traced frames' plane
lookups (metrics/work.py: distinct table rows the frames' sample points
touch, coordinates once, features once, at 3.35 TB/s) over the device time
of the kernels that do them, %."""
from nerfbench.metrics import work

KERNELS = ("kplanes_fwd_fused_kernel<",)


def read(w):
    seconds = w.kernel_seconds(lambda n: any(k in n for k in KERNELS))
    if "plane_bytes" not in w.work or seconds <= 0:
        return None
    return work.roofline_share(w.work["plane_bytes"], w.work["plane_flops"], seconds)
