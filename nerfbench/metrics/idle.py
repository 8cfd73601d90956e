"""idle (idle.<cell kind>): the share of a unit's time (a training step, a
whole frame, a viewer request), untraced, in which no kernel, copy or set
ran on the device: 1 - the union of the device's operations over the
traced units, a unit, over the measured window's seconds a unit
(tracing.Window.idle_share), %."""


def read(w):
    share = w.idle_share()
    return None if share is None else 100.0 * share
