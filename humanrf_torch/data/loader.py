"""Streaming multi-view ray-sampling data loader.

Counterpart of `humanrf_tpu/data/loader.py`, with the same host pool, the
same schedule and the same random draws, so that under one seed both yield
the same batches:

- a pool of `buffer_size` images (uint8 rgb·mask, mask) in host numpy, and
  per-entry camera metadata; a replacer thread cycles new (camera, frame)
  pairs through it from the seeded schedule, under `data_lock`, paused by
  `pause_replacing` around checkpoints and validation;
- TRAINING draws `batch_size` uniform (entry, pixel) pairs per batch from
  `np.random.default_rng(seed)` and gathers their rgba with numpy fancy
  indexing (·(1/255) in float32, the JAX package's `native.gather`);
- `filter_light_bloom` drops the pixels of the subject's border (the mask
  minus its erosion by a square of side round(80/4088 · width)) that lie in
  a filled disc of `light_annotations.csv`: a per-entry `light_ok` beside
  the pool's rgba, gathered into `HostBatch.ray_light_ok` for TRAINING and
  VALIDATION batches (all True otherwise). The erosion and the discs are
  OpenCV's bit for bit (`core/morphology.py`). With `crop_center_square`
  the annotations are shifted by the crop offsets and applied to the
  cropped mask, as in the JAX package;
  `deterministic` replaces one entry synchronously per batch instead of
  running the thread;
- VALIDATION and TEST stream whole images of a render sequence in pixel
  order, the replacer and the consumer handing pool slots over with an
  empty/available semaphore pair.

The batch goes to `device` as a `HostBatch`; the pool's metadata as a cached
`PoolArrays` snapshot; the occupancy grids as a device ring of
corner-dilated grids (`ops/occupancy.py::dilate_grid`). Worker threads never
touch the device: they queue grid uploads, which the consumer thread runs
under `data_lock` before it snapshots the pool.
"""
from __future__ import annotations

import atexit
import itertools
import multiprocessing
import threading
import time
from enum import Enum
from multiprocessing.pool import ThreadPool
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from humanrf_torch.core import morphology
from humanrf_torch.core.dataset import VolumetricDataset
from humanrf_torch.ops.occupancy import dilate_grid
from humanrf_torch.train.pipeline import HostBatch, PoolArrays

_INV_255 = np.float32(1.0) / np.float32(255.0)


class BatchInfo:
    """Host-side metadata accompanying a HostBatch."""

    def __init__(self, num_real: int, width: int, height: int, camera_number=None, frame_number=None):
        self.num_real = num_real
        self.width = width
        self.height = height
        self.camera_number = camera_number
        self.frame_number = frame_number


class DataLoader:
    class Mode(Enum):
        TRAINING = 0
        VALIDATION = 1
        TEST = 2

    class SpacePruningMode(Enum):
        AABB = 0
        OCCUPANCY_GRID = 1

    def __init__(
        self,
        dataset: VolumetricDataset,
        mode: "DataLoader.Mode",
        space_pruning_mode: "DataLoader.SpacePruningMode",
        batch_size: int,
        camera_numbers: Tuple[int, ...],
        frame_numbers: Tuple[int, ...],
        max_buffer_size: int,
        max_num_frames_per_batch: Optional[int] = None,
        use_mask: Optional[bool] = None,
        filter_light_bloom: Optional[bool] = None,
        render_sequence: Optional[List[Tuple[int, int]]] = None,
        seed: int = 0,
        device=None,
        deterministic: bool = False,
    ) -> None:
        self.mode = mode
        self.batch_size = batch_size
        self.device = torch.device(device or "cpu")
        self.rng = np.random.default_rng(seed)
        self.camera_numbers = tuple(camera_numbers)
        if len(set(self.camera_numbers)) != len(self.camera_numbers):
            raise RuntimeError(f"duplicate camera numbers in {self.camera_numbers}")
        self.frame_numbers = tuple(frame_numbers)
        if len(set(self.frame_numbers)) != len(self.frame_numbers):
            raise RuntimeError("duplicate frame numbers in the requested frame set")

        def _check_and_get_arg(arg: Any, name: str, valid_modes, default: Any):
            if self.mode in valid_modes:
                if arg is None:
                    raise RuntimeError(f"{self.mode} requires the '{name}' argument")
                return arg
            if arg is not None:
                raise RuntimeError(f"'{name}' is not a valid argument for {self.mode}")
            return default

        M = DataLoader.Mode
        self.max_num_frames_per_batch = _check_and_get_arg(
            max_num_frames_per_batch, "max_num_frames_per_batch", [M.TRAINING], None
        )
        if self.mode == M.TRAINING:
            if len(self.frame_numbers) > 1 and self.max_num_frames_per_batch < 2:
                raise RuntimeError("multi-frame training needs max_num_frames_per_batch >= 2")
            self.max_num_frames_per_batch = min(self.max_num_frames_per_batch, len(self.frame_numbers))
        self.use_mask = _check_and_get_arg(use_mask, "use_mask", [M.TRAINING, M.VALIDATION], False)
        self.filter_light_bloom = _check_and_get_arg(
            filter_light_bloom, "filter_light_bloom", [M.TRAINING, M.VALIDATION], False
        )
        self.render_sequence = _check_and_get_arg(render_sequence, "render_sequence", [M.VALIDATION, M.TEST], None)

        if self.mode == M.TRAINING:
            self.num_camera_frame_pairs = len(camera_numbers) * len(frame_numbers)
        else:
            self.num_camera_frame_pairs = len(self.render_sequence)

        self.space_pruning_mode = space_pruning_mode
        self.dataset = dataset

        # Scene normalization into the canonical [-0.5, 0.5] cube.
        self.aabb = self.dataset.get_aabb()
        self.scene_offset = -self.aabb.mean(0)
        self.scene_scale = 1.0 / np.max(self.aabb[1] - self.aabb[0])
        self.cameras = self.dataset.get_scaled_cameras(self.scene_offset, self.scene_scale)
        self.all_inverse_krs = np.stack([cam.inverse_kr() for cam in self.cameras]).astype(np.float32)
        self.all_camera_origins = np.stack([cam.translation for cam in self.cameras]).astype(np.float32)
        self.aabb = ((self.aabb + self.scene_offset) * self.scene_scale).astype(np.float32)
        self.device_aabb = torch.tensor(self.aabb, device=self.device)

        unique_num_pixels = list({self.cameras[cn].width * self.cameras[cn].height for cn in self.camera_numbers})
        if len(unique_num_pixels) != 1:
            raise RuntimeError(f"cameras disagree on pixel count: {sorted(unique_num_pixels)}")
        self.num_pixels_per_camera = unique_num_pixels[0]
        self.num_batches_per_full_image = int(np.ceil(self.num_pixels_per_camera / self.batch_size))

        unique_resolutions = list({(self.cameras[cn].width, self.cameras[cn].height) for cn in self.camera_numbers})
        if len(unique_resolutions) > 2 or (
            len(unique_resolutions) == 2
            and not (
                unique_resolutions[0][0] == unique_resolutions[1][1]
                and unique_resolutions[0][1] == unique_resolutions[1][0]
            )
        ):
            raise RuntimeError(f"mixed resolutions beyond a landscape/portrait swap are unsupported: {unique_resolutions}")
        width = max(unique_resolutions[0][0], unique_resolutions[0][1])
        height = min(unique_resolutions[0][0], unique_resolutions[0][1])
        self.resolution = (width, height)

        self.light_annotations = None
        if self.filter_light_bloom:
            self.light_annotations = self.dataset.get_light_annotations()
            self.light_annotations_border_size = round((80 / 4088) * width)

        # Pool sizing.
        self.buffer_size = min(max_buffer_size, self.num_camera_frame_pairs)
        if self.mode == M.TRAINING:
            if self.max_num_frames_per_batch > 1:
                max_reasonable = len(camera_numbers) * (self.max_num_frames_per_batch - 1)
                self.buffer_size = min(self.buffer_size, max_reasonable)
            self.occupancy_grids_buffer_size = min(self.buffer_size, self.max_num_frames_per_batch)
        else:
            self.occupancy_grids_buffer_size = min(self.buffer_size, len(self.frame_numbers))

        B = self.buffer_size
        self.pixel_rgba = np.zeros((B, self.num_pixels_per_camera, 4), dtype=np.uint8)
        self.light_ok = np.ones((B, self.num_pixels_per_camera), dtype=bool)
        self.entry_frame_numbers = np.full((B,), -1, dtype=np.int32)
        self.entry_camera_numbers = np.full((B,), -1, dtype=np.int32)
        self.entry_landscape = np.zeros((B,), dtype=bool)
        self.entry_inverse_krs = np.zeros((B, 3, 3), dtype=np.float32)
        self.entry_camera_origins = np.zeros((B, 3), dtype=np.float32)
        self.entry_grid_slots = np.zeros((B,), dtype=np.int32)
        self._pool_version = 0
        self._pool_cache = None

        self.frame_to_grid_slot = {}
        self.grid_lock = threading.Lock()
        self.occupancy_grid_resolution = 0
        if space_pruning_mode == DataLoader.SpacePruningMode.OCCUPANCY_GRID:
            res = int(self.dataset.get_occupancy_grid(frame_number=self.frame_numbers[0]).shape[0])
            self.occupancy_grid_resolution = res
            self.device_grids = torch.zeros(
                (self.occupancy_grids_buffer_size, res, res, res), dtype=torch.bool, device=self.device
            )
            self.grid_slot_cycle = itertools.cycle(range(self.occupancy_grids_buffer_size))
        else:
            self.device_grids = torch.zeros((1, 1, 1, 1), dtype=torch.bool, device=self.device)
        # Grid uploads queued by worker threads, run by the consumer thread.
        self._pending_grid_entries: List[Tuple[int, int]] = []

        self.data_lock = threading.Lock()
        self.replacer_event = threading.Event()
        self._shutdown = threading.Event()
        self.run_replacer_thread = self.buffer_size < self.num_camera_frame_pairs
        # Deterministic training: one pool entry replaced synchronously per
        # batch instead of a free-running thread; same schedule, reproducible
        # batches.
        self.deterministic = bool(deterministic) and self.mode == M.TRAINING

        if self.run_replacer_thread and self.mode != M.TRAINING:
            self.empty_slots_sem = threading.Semaphore(self.buffer_size)
            self.available_slots_sem = threading.Semaphore(0)

        self.camera_frame_pairs = self._camera_frame_pair_generator()
        preload_pairs = [next(self.camera_frame_pairs) for _ in range(self.buffer_size)]
        pool_threads = min(multiprocessing.cpu_count(), self.buffer_size)
        start = time.time()
        with ThreadPool(pool_threads) as pool:
            pool.starmap(
                self._load_and_copy_camera_frame_data,
                zip(preload_pairs, range(self.buffer_size), itertools.repeat(None)),
            )
        print(f"Images are loaded in {time.time() - start:.2f}s by a pool of {pool_threads} threads.")
        self.pair_load_index = self.buffer_size

        self._replacer_thread = None
        if self.run_replacer_thread and not self.deterministic:
            self._replacer_thread = threading.Thread(target=self._replace_next_buffer_entry, daemon=True)
            self._replacer_thread.start()
        atexit.register(self.shutdown)

    # -------------------------------------------------------------- schedule

    def _camera_frame_pair_generator(self):
        """(camera, frame) schedule: cycle the render sequence for
        VALIDATION/TEST; for TRAINING, iterate shuffled frames and emit
        `num_cams_per_frame` shuffled cameras per frame, so that at most
        `max_num_frames_per_batch` frames coexist in the pool."""
        if self.mode != DataLoader.Mode.TRAINING:
            yield from itertools.cycle(self.render_sequence)
            return

        if self.max_num_frames_per_batch > 1:
            num_cams_per_frame = int(np.ceil(self.buffer_size / (self.max_num_frames_per_batch - 1)))
        else:
            assert len(self.frame_numbers) == 1
            num_cams_per_frame = len(self.camera_numbers)
        assert num_cams_per_frame <= len(self.camera_numbers)

        per_frame = {
            fn: {"next_yield_index": 0, "camera_numbers": list(self.camera_numbers)} for fn in self.frame_numbers
        }
        frame_numbers = list(self.frame_numbers)
        while True:
            self.rng.shuffle(frame_numbers)
            for fn in frame_numbers:
                info = per_frame[fn]
                for _ in range(num_cams_per_frame):
                    if info["next_yield_index"] == 0:
                        self.rng.shuffle(info["camera_numbers"])
                    yield info["camera_numbers"][info["next_yield_index"]], fn
                    info["next_yield_index"] = (info["next_yield_index"] + 1) % len(info["camera_numbers"])

    # -------------------------------------------------------------- replacer

    def shutdown(self):
        """Stop the replacer thread (also at interpreter exit). It checks the
        shutdown event before every blocking wait, so the join returns within
        one image load. Idempotent."""
        atexit.unregister(self.shutdown)
        self._shutdown.set()
        self.replacer_event.set()
        if self.run_replacer_thread and self.mode != DataLoader.Mode.TRAINING:
            self.empty_slots_sem.release()  # unblock a replacer waiting for a slot
        t = self._replacer_thread
        if t is not None and t.is_alive():
            t.join(timeout=30.0)
            if t.is_alive():
                print("[WARNING] DataLoader.shutdown: replacer thread still alive after 30s")
        self._replacer_thread = None

    def _replace_next_buffer_entry(self):
        for pair in self.camera_frame_pairs:
            while not self.replacer_event.wait(timeout=0.25):
                if self._shutdown.is_set():
                    return
            if self._shutdown.is_set():
                return
            self._evict_stale_grid_slots()
            self._load_and_copy_camera_frame_data(pair, self.pair_load_index % self.buffer_size, self.data_lock)
            self.pair_load_index += 1

    def _evict_stale_grid_slots(self):
        if (
            self.space_pruning_mode == DataLoader.SpacePruningMode.OCCUPANCY_GRID
            and self.mode == DataLoader.Mode.TRAINING
        ):
            with self.grid_lock:
                live = set(self.entry_frame_numbers.tolist())
                for fn in [f for f in self.frame_to_grid_slot if f not in live]:
                    self.frame_to_grid_slot.pop(fn)
            assert len(self.frame_to_grid_slot) <= self.occupancy_grids_buffer_size

    def _replace_one_sync(self):
        """Deterministic-mode replacement: one entry, on the caller's thread."""
        pair = next(self.camera_frame_pairs)
        self._evict_stale_grid_slots()
        self._load_and_copy_camera_frame_data(pair, self.pair_load_index % self.buffer_size, None)
        self.pair_load_index += 1

    def _queue_grid_slot(self, buffer_index: int, frame_number: int) -> int:
        """The frame's device slot when it has one, else queue its upload for
        the consumer thread and return -1 (pending)."""
        with self.grid_lock:
            if frame_number in self.frame_to_grid_slot:
                return self.frame_to_grid_slot[frame_number]
            self._pending_grid_entries.append((buffer_index, frame_number))
        return -1

    def _resolve_pending_grids(self) -> None:
        """Consumer side, under `data_lock`: upload every queued grid of a
        live frame and patch the pool's slot column."""
        with self.grid_lock:
            if not self._pending_grid_entries:
                return
            pending, self._pending_grid_entries = self._pending_grid_entries, []
            for _buffer_index, frame_number in pending:
                live = self.entry_frame_numbers == frame_number
                if not live.any():
                    continue
                self.entry_grid_slots[live] = self._upload_grid(frame_number)
            self._pool_version += 1

    def _upload_grid(self, frame_number: int) -> int:
        """Dilate a frame's grid into a device slot (memoized per frame);
        consumer thread only, under `grid_lock`.

        The slot is the ring's next one that no live frame holds. The JAX
        loader takes the ring's next slot as it is: when the free-running
        replacer commits several frames between two fetches, a queued frame
        that is no longer live is skipped, the ring's order drifts, and the
        next upload lands on the slot of a frame whose entries still point
        there. When the next slot is free, as it always is with one
        replacement per fetch (`deterministic`), both choose the same slot."""
        if frame_number in self.frame_to_grid_slot:
            return self.frame_to_grid_slot[frame_number]
        grid = torch.as_tensor(self.dataset.get_occupancy_grid(frame_number), device=self.device)
        live = set(self.entry_frame_numbers.tolist())
        held = {s for fn, s in self.frame_to_grid_slot.items() if fn in live}
        for _ in range(self.occupancy_grids_buffer_size):
            slot = next(self.grid_slot_cycle)
            if slot not in held:
                break
        else:
            raise RuntimeError(f"no free occupancy-grid slot for frame {frame_number}: live frames hold {held}")
        for fn, s in list(self.frame_to_grid_slot.items()):
            if s == slot:
                self.frame_to_grid_slot.pop(fn)
        # A new tensor, not an in-place write: a batch handed out before keeps
        # its grids.
        grids = self.device_grids.clone()
        grids[slot] = dilate_grid(grid)
        self.device_grids = grids
        self.frame_to_grid_slot[frame_number] = slot
        return slot

    def _load_and_copy_camera_frame_data(
        self, camera_frame_pair: Tuple[int, int], buffer_index: int, data_lock: Optional[threading.Lock]
    ) -> None:
        camera_number, frame_number = camera_frame_pair
        camera = self.cameras[camera_number]
        if self._shutdown.is_set():
            return

        rgba = light_ok = None
        if self.mode != DataLoader.Mode.TEST:
            rgb = self.dataset.get_rgb(camera_number, frame_number)[..., [2, 1, 0]]  # BGR → RGB
            if self.use_mask:
                mask = self.dataset.get_mask(camera_number, frame_number)
                rgb = rgb * mask
            else:
                mask = np.ones_like(rgb[..., 0:1])
            rgba = (np.concatenate((rgb, mask), axis=-1) * np.float32(255)).astype(np.uint8).reshape(-1, 4)
            if self.light_annotations is not None:
                light_ok = self._light_ok(mask[..., 0], self.light_annotations[camera_number])

        if self.run_replacer_thread and self.mode != DataLoader.Mode.TRAINING:
            self.empty_slots_sem.acquire()
        if self._shutdown.is_set():
            return

        if data_lock is not None:
            data_lock.acquire()
        try:
            grid_slot = 0
            if self.space_pruning_mode == DataLoader.SpacePruningMode.OCCUPANCY_GRID:
                grid_slot = self._queue_grid_slot(buffer_index, frame_number)
            if self.mode != DataLoader.Mode.TEST:
                self.pixel_rgba[buffer_index] = rgba
                self.light_ok[buffer_index] = True if light_ok is None else light_ok
            self.entry_frame_numbers[buffer_index] = frame_number
            self.entry_camera_numbers[buffer_index] = camera_number
            self.entry_landscape[buffer_index] = camera.width > camera.height
            self.entry_inverse_krs[buffer_index] = self.all_inverse_krs[camera_number]
            self.entry_camera_origins[buffer_index] = self.all_camera_origins[camera_number]
            self.entry_grid_slots[buffer_index] = grid_slot
            self._pool_version += 1
        finally:
            if data_lock is not None:
                data_lock.release()

        if self.run_replacer_thread and self.mode != DataLoader.Mode.TRAINING:
            for _ in range(self.num_batches_per_full_image):
                self.available_slots_sem.release()

    def _light_ok(self, mask: np.ndarray, discs) -> np.ndarray:
        """(H·W,) bool: False where the subject's border meets a disc (x, y, r)."""
        person_border = mask - morphology.erode(mask, self.light_annotations_border_size)
        light_mask = np.zeros(mask.shape, dtype=np.uint8)
        for x, y, r in discs:
            morphology.fill_circle(light_mask, (x, y), r, 255)
        return ~((person_border > 0) & (light_mask > 0)).reshape(-1)

    # -------------------------------------------------------------- sampling

    def pause_replacing(self):
        self.replacer_event.clear()

    def continue_replacing(self):
        self.replacer_event.set()

    def __len__(self):
        if self.mode == DataLoader.Mode.TRAINING:
            raise NotImplementedError("the training stream is endless; len() only applies to validation/test")
        return self.num_camera_frame_pairs * self.num_pixels_per_camera

    def __iter__(self):
        self.iternum = 0
        self.continue_replacing()
        return self

    def pool_arrays(self) -> PoolArrays:
        """The pool's metadata on the device, cached per pool version. Called
        under `data_lock`; copies, since the replacer rewrites the host arrays
        in place after the snapshot is handed out."""
        if self._pool_cache is None or self._pool_cache[0] != self._pool_version:
            snapshot = PoolArrays(
                *(
                    torch.tensor(a.copy(), device=self.device)
                    for a in (
                        self.entry_inverse_krs,
                        self.entry_camera_origins,
                        self.entry_landscape,
                        self.entry_frame_numbers,
                        self.entry_camera_numbers,
                        self.entry_grid_slots,
                    )
                )
            )
            self._pool_cache = (self._pool_version, snapshot)
        return self._pool_cache[1]

    def __next__(self):
        """→ (HostBatch, PoolArrays, grids, BatchInfo)."""
        M = DataLoader.Mode
        if self.mode in (M.VALIDATION, M.TEST) and self.iternum >= len(self):
            self.pause_replacing()
            raise StopIteration

        width, height = self.resolution
        R = self.batch_size
        if self.mode == M.TRAINING:
            # replacer_event doubles as the pause gate, so deterministic
            # replacement honours it too.
            if self.deterministic and self.run_replacer_thread and self.replacer_event.is_set():
                self._replace_one_sync()
            buffer_idx = self.rng.integers(0, self.buffer_size, size=R).astype(np.int32)
            pixel_idx = self.rng.integers(0, self.num_pixels_per_camera, size=R).astype(np.int32)
            with self.data_lock:
                self._resolve_pending_grids()
                rgba = self.pixel_rgba[buffer_idx, pixel_idx].astype(np.float32) * _INV_255
                light_ok = self._gather_light_ok(buffer_idx, pixel_idx)
                pool = self.pool_arrays()
                grids = self.device_grids
            info = BatchInfo(num_real=R, width=width, height=height)
            num_real = R
        else:
            ray_start = self.iternum % self.num_pixels_per_camera
            ray_end = min(ray_start + R, self.num_pixels_per_camera)
            num_real = ray_end - ray_start
            image_num = self.iternum // self.num_pixels_per_camera
            camera_number, frame_number = self.render_sequence[image_num]
            buffer_index = image_num % self.buffer_size

            if self.run_replacer_thread:
                self.available_slots_sem.acquire()
            with self.data_lock:
                self._resolve_pending_grids()
                if not self.entry_landscape[buffer_index]:
                    width, height = height, width  # portrait image
                pixel_idx = np.arange(ray_start, ray_end, dtype=np.int32)
                pixel_idx = np.concatenate([pixel_idx, np.zeros(R - num_real, dtype=np.int32)])
                buffer_idx = np.full(R, buffer_index, dtype=np.int32)
                if self.mode == M.VALIDATION:
                    rgba = self.pixel_rgba[buffer_idx, pixel_idx].astype(np.float32) / 255.0
                else:
                    rgba = np.zeros((R, 4), dtype=np.float32)
                light_ok = self._gather_light_ok(buffer_idx, pixel_idx)
                pool = self.pool_arrays()
                grids = self.device_grids
            if self.run_replacer_thread and ray_end == self.num_pixels_per_camera:
                self.empty_slots_sem.release()  # last batch of the image: its slot is free
            info = BatchInfo(num_real, width, height, camera_number, frame_number)

        self.iternum += num_real
        batch = HostBatch(
            buffer_idx=torch.from_numpy(buffer_idx).to(self.device),
            pixel_idx=torch.from_numpy(pixel_idx).to(self.device),
            rgba=torch.from_numpy(rgba).to(self.device),
            ray_light_ok=torch.from_numpy(light_ok).to(self.device),
        )
        return batch, pool, grids, info

    def _gather_light_ok(self, buffer_idx: np.ndarray, pixel_idx: np.ndarray) -> np.ndarray:
        if self.filter_light_bloom:
            return self.light_ok[buffer_idx, pixel_idx]
        return np.ones(buffer_idx.shape[0], dtype=bool)
