"""Ways to break the timed path underneath, for the checks that the
comparison with the reference refuses a broken program (the tests, and
nerfbench/probe.py on the chip).  No run of the benchmark uses them."""
from __future__ import annotations

TRAIN = ("unchanged", "half_batch")
RENDER = ("altered",)


def break_train_step(step, fault: str) -> None:
    """``unchanged``: each step returns its state as it found it but for
    the step counter; ``half_batch``: each step's loss and gradients are
    the mean over the first half of its rays, the rest left out."""
    if fault == "unchanged":
        def apply_grads(state, grads):
            state.step += 1

        step.apply_grads = apply_grads
    elif fault == "half_batch":
        inner = step.loss_and_grads

        def loss_and_grads(state, batch, **kwargs):
            n = batch["cam_idx"].shape[0] // 2
            return inner(state, {k: v[:n] for k, v in batch.items()}, **kwargs)

        step.loss_and_grads = loss_and_grads
    else:
        raise ValueError(f"no train fault {fault!r}")


def break_render(render, fault: str):
    """``altered``: the render's rgb raised by 1/32 on every 16th pixel
    where it is produced."""
    if fault != "altered":
        raise ValueError(f"no render fault {fault!r}")

    def altered(*args, **kwargs):
        out = render(*args, **kwargs)
        rgb = out["rgb"].clone()
        flat = rgb.view(-1, 3)
        flat[::16] += 1.0 / 32
        return {**out, "rgb": rgb}

    return altered
