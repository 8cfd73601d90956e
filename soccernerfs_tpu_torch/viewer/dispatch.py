"""The viewer's renders over a world of ranks (the JAX viewer's renders
are ``Trainer.render_camera`` calls, each a ``shard_map`` over the data
mesh of every local device).

Over a world every rank must make the same collective calls, in the same
order, from one thread; the viewer answers HTTP on many threads of rank 0
alone.  So no handler thread renders:

  * every render that rank 0's server wants (a ``/render``, a path job's
    frame) is queued on its ``Dispatcher`` as one camera of host arrays
    and a chunk, and the asking thread waits for the outputs;
  * the dispatcher serves the queue from one thread: it broadcasts a
    message over the world's group (``broadcast_object_list``) holding the
    queued cameras and chunks and whether to stop, then every rank makes
    the same ``Trainer.render_camera`` call for each, splitting each
    chunk's rays over the ranks.  It is the only place on rank 0 that
    renders with a world;
  * the other ranks loop on that broadcast (``follow``) until a message
    says stop.

Standalone (``snt-viewer`` over several ranks) rank 0's main thread runs
``run`` until the server stops (``stop``), broadcasting an empty message
every ``HEARTBEAT_S`` seconds while idle so that the other ranks' wait
stays within the group's timeout.  Under training (``snt-train --vis
viewer`` over several ranks) every rank calls ``serve_pending`` between
steps: rank 0 broadcasts what is queued (most steps, nothing), so a
request waits at most one step.  A render draws nothing from any
generator.

A cancelled request (its ``cancelled()`` true when the dispatcher takes
it) is dropped before the broadcast: no rank starts it.  Any failure of
a render is fatal: the dispatcher fails every queued request and stops
taking new ones, and the error propagates; a failure outside a render
(rank 0 interrupted while idle) first broadcasts the stop, so no other
rank is left waiting."""
from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from soccernerfs_tpu_torch.core.cameras import Cameras

# seconds an idle standalone viewer waits before it broadcasts an empty
# message (far below the group's timeout)
HEARTBEAT_S = 10.0


class RenderCancelled(Exception):
    """A queued render whose request was cancelled before it started."""


def host_camera(cameras: Cameras, index: int) -> Dict[str, np.ndarray]:
    """Camera ``index`` of ``cameras`` as a one-camera dict of host arrays
    (``Cameras``' fields; a message carries no device tensor)."""
    return {f.name: getattr(cameras, f.name)[index:index + 1].cpu().numpy()
            for f in dataclasses.fields(cameras)
            if getattr(cameras, f.name) is not None}


def device_cameras(host: Dict[str, np.ndarray], device) -> Cameras:
    """``host_camera``'s arrays back as ``Cameras`` on ``device``."""
    return Cameras(**{k: torch.from_numpy(np.array(v)).to(device)
                      for k, v in host.items()})


@dataclasses.dataclass
class _Request:
    camera: Dict[str, np.ndarray]
    chunk: Optional[int]
    cancelled: Callable[[], bool]
    done: threading.Event = dataclasses.field(default_factory=threading.Event)
    outputs: Optional[Dict[str, np.ndarray]] = None
    error: Optional[BaseException] = None

    def finish(self, outputs=None, error=None) -> None:
        self.outputs, self.error = outputs, error
        self.done.set()


class Dispatcher:
    """Renders of ``trainer`` (on a rank of its world) for a viewer; see the
    module's text.  ``renders`` counts the renders this rank took part
    in."""

    def __init__(self, trainer):
        if trainer.world is None:
            raise ValueError("a Dispatcher renders over a world of ranks")
        self.trainer = trainer
        self.world = trainer.world
        self.renders = 0
        self._queue: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._lock = threading.Lock()
        self._closed: Optional[str] = None
        self._stopping = threading.Event()

    # -- rank 0, any thread ------------------------------------------------
    def render(self, cameras: Cameras, index: int, chunk: Optional[int] = None,
               cancelled: Callable[[], bool] = lambda: False
               ) -> Dict[str, np.ndarray]:
        """Queue camera ``index`` of ``cameras`` and wait for its outputs
        (host arrays, as ``Trainer.render_camera`` returns them); raises
        ``RenderCancelled`` when ``cancelled()`` holds as the dispatcher
        takes it, and RuntimeError once the dispatcher has closed."""
        request = _Request(host_camera(cameras, index), chunk, cancelled)
        with self._lock:
            if self._closed is not None:
                raise RuntimeError(self._closed)
            self._queue.put(request)
        request.done.wait()
        if request.error is not None:
            raise request.error
        return request.outputs

    def pending(self) -> int:
        """Requests queued and not yet taken."""
        return self._queue.qsize()

    def stop(self) -> None:
        """Make ``run`` broadcast the stop once the queue is served."""
        self._stopping.set()
        self._queue.put(None)

    def close(self, reason: str) -> None:
        """Fail every queued request and refuse new ones with ``reason``."""
        with self._lock:
            if self._closed is None:
                self._closed = reason
        for request in self._take(None):
            request.finish(error=RuntimeError(reason))

    # -- every rank ----------------------------------------------------------
    def _take(self, timeout: Optional[float]) -> List[_Request]:
        """The queued requests: waits up to ``timeout`` seconds for the first
        (None: none), then takes the rest without waiting."""
        taken = []
        try:
            item = (self._queue.get_nowait() if timeout is None
                    else self._queue.get(timeout=timeout))
            while True:
                if item is not None:
                    taken.append(item)
                item = self._queue.get_nowait()
        except queue.Empty:
            return taken

    def _exchange(self, requests: Optional[List[_Request]], stop: bool = False
                  ) -> dict:
        """One message from rank 0 to every rank: rank 0 drops the cancelled
        ``requests`` (finishing them) and sends the rest; the others pass
        None and get it."""
        message = None
        if requests is not None:
            for r in requests:
                if r.cancelled():
                    r.finish(error=RenderCancelled("render cancelled"))
            requests[:] = [r for r in requests if not r.done.is_set()]
            message = {"renders": [{"camera": r.camera, "chunk": r.chunk}
                                   for r in requests], "stop": stop}
        box = [message]
        dist.broadcast_object_list(box, src=0, group=self.world.group)
        return box[0]

    def _render_all(self, message: dict,
                    requests: Optional[List[_Request]] = None) -> None:
        """Every render of ``message``, split over the ranks; rank 0 hands
        each its outputs."""
        for i, item in enumerate(message["renders"]):
            cameras = device_cameras(item["camera"], self.trainer.device)
            outputs = self.trainer.render_camera(cameras, 0, item["chunk"])
            self.renders += 1
            if requests is not None:
                requests[i].finish(outputs)

    def _serve(self, requests: Optional[List[_Request]], stop: bool) -> dict:
        """Broadcast, then render; a failure in the render closes the
        dispatcher (the other ranks fail in their collectives)."""
        message = self._exchange(requests, stop)
        try:
            self._render_all(message, requests)
        except BaseException as e:
            for r in requests or ():
                if not r.done.is_set():
                    r.finish(error=RuntimeError(f"render failed: {e!r}"))
            self.close(f"the viewer's renders stopped: {e!r}")
            raise
        return message

    def run(self) -> int:
        """Rank 0's loop of a standalone viewer, until ``stop``: serve the
        queue, broadcast an empty message when idle for HEARTBEAT_S, then
        the stop.  Returns ``renders``."""
        serving = False
        try:
            while True:
                requests = self._take(HEARTBEAT_S)
                stop = self._stopping.is_set() and self._queue.empty()
                if stop:
                    # a request queued from now on fails at once
                    self.close("the viewer has stopped")
                serving = True
                self._serve(requests, stop)
                serving = False
                if stop:
                    return self.renders
        except BaseException:
            self.close("the viewer's renders stopped")
            if not serving:
                # idle: every other rank waits in the broadcast
                with contextlib.suppress(Exception):
                    self._exchange([], stop=True)
            raise

    def release(self) -> None:
        """Rank 0, when it fails before ``run`` (its server did not start):
        broadcast the stop, so no other rank waits for a message."""
        self.close("the viewer did not start")
        self._exchange([], stop=True)

    def follow(self) -> int:
        """Another rank's loop: every message's renders, until the stop.
        Returns ``renders``."""
        while True:
            message = self._serve(None, False)
            if message["stop"]:
                return self.renders

    def serve_pending(self) -> None:
        """Between training steps, on every rank: rank 0 broadcasts what is
        queued (often nothing) and every rank renders it."""
        self._serve(self._take(None) if self.world.rank == 0 else None, False)
