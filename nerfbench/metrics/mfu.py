"""mfu (mfu.<cell kind>): model FLOPs of the traced units (the
configuration's work module, metrics/work.py or work_hash.py: MLP GEMMs,
plane or hash lookups and their products; forward once, and in a training
step backward twice, the proposals' backward on update steps only) a
second of the measured window, untraced (tracing.Window.rate: its seconds
a unit), as a share of the H100's 989 TFLOP/s bf16 peak, %."""
from nerfbench.metrics import work


def read(w):
    rate = w.rate(w.work.get("model_flops"))
    return None if rate is None else 100.0 * rate / work.H100_BF16_FLOPS
