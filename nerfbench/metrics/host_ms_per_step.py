"""host_ms_per_step (host_ms_per_step.<train cell kind>): the median host-clock span of one
``train_iteration`` call in the measured window, which holds no
synchronise: what the host spends to enqueue a step, ms."""
import statistics


def read(w):
    spans = w.spans_ms.get("train_iteration")
    return statistics.median(spans) if spans else None
