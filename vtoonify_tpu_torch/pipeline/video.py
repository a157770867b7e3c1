"""Double-buffered video engine: decode -> device -> encode, overlapped
(port of vtoonify_tpu/pipeline/video.py: `VideoResult`,
`iterate_video_frames`, `_PrefetchIterator`, `_AsyncWriter`,
`toonify_video`).

`toonify_frames` is the engine: it batches any iterable of (fps, RGB uint8
frame) into `ToonifyPipeline.process_batch` calls and hands the stylized
frames to any writer (packed frames from a `packed_output` pipeline, which
the file writer finishes with `native.depth_to_space2_u8`). `process_batch`
returns its device tensor before the
card has finished, so up to `max_in_flight` batches are queued before the
oldest is fetched: the host preprocesses the next batch while the card
computes. A batch on a card is copied to the host as soon as it is
dispatched, on a copy stream behind an event on the batch's own stream,
into a page-locked block of torch's caching host allocator; the fetch
waits for that batch's compute and copy only, so the batches queued
behind it keep the card busy. `toonify_video` wraps the engine
with cv2 decode on a prefetch thread and cv2 encode on a writer thread.
cv2 is imported only there, so the engine runs over in-memory frames where
cv2 is not installed.
"""

from __future__ import annotations

import collections
import queue
import threading
from dataclasses import dataclass
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from vtoonify_tpu_torch import native
from vtoonify_tpu_torch.pipeline import crop as crop_mod
from vtoonify_tpu_torch.utils.profiling import span


@dataclass
class VideoResult:
    frames_written: int
    crop_params: Optional[tuple]
    stages: Optional[dict] = None  # StageTimer summary when profiling


def iterate_video_frames(path: str):
    """Decode frames as (fps, RGB uint8 array)."""
    import cv2

    cap = cv2.VideoCapture(path)
    try:
        fps = cap.get(cv2.CAP_PROP_FPS)
        n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        for _ in range(n):
            ok, frame = cap.read()
            if not ok:
                break
            yield fps, native.rgb_to_bgr(frame)
    finally:
        cap.release()


class _PrefetchIterator:
    """Decode-ahead thread: pulls items from an iterator into a bounded queue.

    The engine's main thread blocks in the fetch once `max_in_flight`
    batches are queued; without prefetch, decoding is serialized with those
    stalls. With it, cv2 decode runs concurrently and the main-thread
    "decode" stage in the profile measures only *exposed* decode time (queue
    waits), not total decoder work.
    """

    _SENTINEL = object()

    def __init__(self, iterator, depth: int = 16):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, args=(iterator,),
                                        daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self, iterator):
        try:
            for item in iterator:
                if not self._put(item):
                    return
        except BaseException as e:  # surfaced on the consumer thread
            self._err = e
        finally:
            self._put(self._SENTINEL)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._SENTINEL:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self):
        """Stop the producer early (e.g. frame_limit hit) and drain."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join()


class _AsyncWriter:
    """cv2.VideoWriter fed with RGB frames from a bounded queue on a worker
    thread, which swaps them to BGR (`native.rgb_to_bgr`); with `packed`,
    frames are a packed_output pipeline's (2H, 2W, 12), finished there by
    `native.depth_to_space2_u8` fused with the swap."""

    def __init__(self, path: str, fps: float, size_wh, maxsize: int = 8,
                 timer=None, packed: bool = False):
        import cv2

        self._writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"),
                                       fps, size_wh)
        self._q: queue.Queue = queue.Queue(maxsize=maxsize)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._count = 0
        self._timer = timer
        self._packed = packed
        self._thread.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                break
            with span("engine.encode", self._timer):
                self._writer.write(native.depth_to_space2_u8(item, bgr=True)
                                   if self._packed else native.rgb_to_bgr(item))
            self._count += 1

    def write(self, frame_rgb_u8: np.ndarray):
        self._q.put(frame_rgb_u8)

    def close(self) -> int:
        self._q.put(None)
        self._thread.join()
        self._writer.release()
        return self._count


class MemoryWriter:
    """A writer that keeps the frames in memory (or, with keep=False, only
    counts them). The kept frames are the engine's views: on a card each
    keeps its batch's page-locked host block until the frames are dropped."""

    def __init__(self, keep: bool = True):
        self.keep = keep
        self.frames = []
        self.count = 0

    def write(self, frame_rgb_u8: np.ndarray):
        if self.keep:
            self.frames.append(frame_rgb_u8)
        self.count += 1

    def close(self) -> int:
        return self.count


def toonify_frames(
    pipeline,
    frames: Iterable,
    open_writer: Callable,
    *,
    style_degree: float = 0.5,
    color_transfer: bool = False,
    landmarker=None,
    scale_image: bool = True,
    padding=(200, 200, 200, 200),
    batch_size: Optional[int] = None,  # None -> resolution-aware auto
    max_in_flight: int = 3,
    open_crop_writer: Optional[Callable] = None,
    s_w=None,
    parsing_maps: Optional[np.ndarray] = None,
    frame_limit: Optional[int] = None,
    timer=None,
) -> VideoResult:
    """Stylize a stream of (fps, RGB uint8 frame) (reference
    style_transfer.py video branch) into `open_writer(fps, (4W, 4H))`, a
    writer with `write(frame)` and `close() -> frames written`, opened at
    the first frame; `open_crop_writer(fps, (W, H))` gets the crops. A
    `packed_output` pipeline's frames reach the writer packed, (2H, 2W, 12).

    The first frame fixes the crop parameters and the style code for the
    whole stream (style_transfer.py:113-150). `s_w` may be passed directly
    to skip alignment. `parsing_maps` (N, H, W, 19) overrides BiSeNet.

    Each stage is a `utils.profiling.span` `vt::engine.<stage>`: decode,
    preprocess, stack (a batch's frames into one array), dispatch
    (`process_batch` until it returns), copy_enqueue (on a card only: the
    batch's copy to a page-locked host block queued on a copy stream, right
    after the dispatch; its count is the batches that took this path),
    fetch (a batch to the host), write (its frames to the writer, then the
    batch released) and, in a file writer's thread, encode. `fetch` holds
    fetch_wait (on a card: the wait for the copy's done event, that is for
    the batch's compute and its copy, not for the batches queued after it)
    and fetch_copy (on a card the numpy view of the page-locked block; on
    the CPU `.cpu().numpy()`); their sum is `fetch`. Pass a `StageTimer` as
    `timer` to get these totals, by stage name, in `result.stages`; under
    `torch.profiler` they are host ranges in the trace.

    The writer gets each frame as a numpy view into its batch's host copy,
    valid for as long as the writer holds it: a writer that keeps frames
    keeps their batch's page-locked block, which torch's host allocator
    reuses only once the last view is gone.
    `batch_size=None` picks a resolution-aware batch from the first crop's
    size (`model_api.dynamic_batch_size`).
    """
    from vtoonify_tpu_torch.pipeline.model_api import dynamic_batch_size

    crop_params = None
    writer = None
    crop_writer = None
    # (device batch, its page-locked host copy, the copy's done event,
    # frames to write); the device batch is kept until the fetch has waited,
    # so the device allocator cannot reuse it under the copy
    in_flight = collections.deque()
    copy_streams = {}
    batch = []
    first = True
    frame_idx = 0

    def enqueue_copy(dev_batch):
        """Queue `dev_batch`'s copy to a page-locked host block on the
        device's copy stream, behind the work queued so far on the batch's
        stream; return the block and the copy's done event."""
        with span("engine.copy_enqueue", timer):
            dev = dev_batch.device
            stream = copy_streams.get(dev)
            if stream is None:
                stream = copy_streams[dev] = torch.cuda.Stream(dev)
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                # a strided batch (a size_bucket crop) is packed on the card,
                # in the copy stream's pool, so freeing it here is safe
                src = dev_batch.contiguous()
                pinned = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
                pinned.copy_(src, non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
        return pinned, done

    def flush_ready(block: bool):
        while in_flight and (block or len(in_flight) >= max_in_flight):
            dev_batch, pinned, done, count = in_flight.popleft()
            with span("engine.fetch", timer):
                if done is not None:
                    with span("engine.fetch_wait", timer):
                        done.synchronize()
                with span("engine.fetch_copy", timer):
                    host = dev_batch.cpu().numpy() if pinned is None else pinned.numpy()
            with span("engine.write", timer):
                for k in range(count):
                    writer.write(host[k])
                # the batch is released here, inside the span: a page-locked
                # block returns to torch's host cache once no frame of it is
                # held
                del host, pinned, dev_batch

    def submit(batch_frames):
        with span("engine.stack", timer):
            arr = np.stack(batch_frames)
            if parsing_maps is not None:
                pm = parsing_maps[frame_idx - len(batch_frames): frame_idx]
            # a frame-parallel pipeline splits a batch evenly over its dp rows
            # (a (dp, tp) mesh's dp width): a short last batch is topped up with
            # its last frame (not written); a spatial mesh splits rows and takes
            # any batch
            mesh = getattr(pipeline, "mesh", None)
            extra = 0 if mesh is None else -len(arr) % mesh.shape.get("dp", 1)
            if extra:
                arr = np.concatenate([arr, np.repeat(arr[-1:], extra, 0)])
                if parsing_maps is not None:
                    pm = np.concatenate([pm, np.repeat(pm[-1:], extra, 0)])
        with span("engine.dispatch", timer):
            if parsing_maps is not None:
                out = pipeline.process_batch_with_parsing(arr, pm, s_w, style_degree)
            else:
                out = pipeline.process_batch(arr, s_w, style_degree)
        pinned, done = enqueue_copy(out) if out.is_cuda else (None, None)
        in_flight.append((out, pinned, done, len(batch_frames)))
        flush_ready(block=False)

    frame_iter = iter(frames)
    while True:
        with span("engine.decode", timer):
            item = next(frame_iter, None)
        if item is None:
            break
        fps, frame = item
        if frame_limit is not None and frame_idx >= frame_limit:
            break
        if first:
            if scale_image and landmarker is not None:
                crop_params = crop_mod.get_video_crop_parameter(frame, landmarker,
                                                                padding)
            frame = crop_mod.preprocess_frame(frame, crop_params, scale_image)
            h, w = frame.shape[:2]
            if batch_size is None:
                batch_size = dynamic_batch_size(
                    w, h, on_accelerator=pipeline.device.type == "cuda")
            writer = open_writer(fps, (4 * w, 4 * h))
            if open_crop_writer is not None:
                crop_writer = open_crop_writer(fps, (w, h))
            if s_w is None:
                aligned = crop_mod.align_face(frame, landmarker)
                s_w = pipeline.compute_style(aligned, color_transfer)
            first = False
        else:
            with span("engine.preprocess", timer):
                frame = crop_mod.preprocess_frame(frame, crop_params, scale_image)

        if crop_writer is not None:
            crop_writer.write(frame)
        batch.append(frame)
        frame_idx += 1
        if len(batch) == batch_size:
            submit(batch)
            batch = []

    if batch:
        submit(batch)
    flush_ready(block=True)

    written = writer.close() if writer else 0
    if crop_writer is not None:
        crop_writer.close()
    return VideoResult(frames_written=written, crop_params=crop_params,
                       stages=timer.summary() if timer is not None else None)


def toonify_video(
    pipeline,
    in_path: str,
    out_path: str,
    *,
    style_degree: float = 0.5,
    color_transfer: bool = False,
    landmarker=None,
    scale_image: bool = True,
    padding=(200, 200, 200, 200),
    batch_size: Optional[int] = None,
    max_in_flight: int = 3,
    crop_out_path: Optional[str] = None,
    s_w=None,
    parsing_maps: Optional[np.ndarray] = None,
    frame_limit: Optional[int] = None,
    timer=None,
) -> VideoResult:
    """Stylize the video file `in_path` into the mp4 `out_path` (4x the
    crop), and the crops into `crop_out_path` when given: `toonify_frames`
    between a cv2 decode thread and cv2 encode threads."""
    frame_iter = _PrefetchIterator(iterate_video_frames(in_path),
                                   depth=max(16, 2 * (batch_size or 16)))
    open_crop_writer = None
    if crop_out_path:
        def open_crop_writer(fps, size_wh):
            return _AsyncWriter(crop_out_path, fps, size_wh)
    try:
        return toonify_frames(
            pipeline, frame_iter,
            lambda fps, size_wh: _AsyncWriter(
                out_path, fps, size_wh, timer=timer,
                packed=pipeline.packed_output),
            style_degree=style_degree, color_transfer=color_transfer,
            landmarker=landmarker, scale_image=scale_image, padding=padding,
            batch_size=batch_size, max_in_flight=max_in_flight,
            open_crop_writer=open_crop_writer, s_w=s_w,
            parsing_maps=parsing_maps, frame_limit=frame_limit, timer=timer)
    finally:
        frame_iter.close()
