"""The folder inference engine (reference NeuralBarkCalculator,
models.py:206-364), in PyTorch for one CUDA card.

The reference runs strictly batch_size=1. Here the whole folder is
batched:

- processed images (uint8, width 1024, ragged trimmed heights) are grouped
  into static height buckets (multiples of PredictConfig.height_bucket) and
  batched up a power-of-two ladder; per-image row masks and embedded
  bicubic row operators make the padded batch exactly equivalent to
  per-image execution (models/resnet.py, ops/resize.py);
- one device step per batch: uint8 -> float, normalize, re-zero the rows
  past each image's height, the model's backbone + head (``head_logits``:
  cuDNN convolutions, bf16 and channels_last by default) under
  ``torch.inference_mode()``, then the hand-written CUDA kernel
  ``upsample_argmax`` (bicubic upsample + argmax in one pass), then a
  2-bit pack so the pull moves a quarter of the bytes;
- EfficientNet backbones cannot run masked ragged batches exactly (the
  TF-SAME stride phase, models/efficientnet.py): their images are grouped
  by true trimmed height instead, one launch shape per distinct height,
  with no row masks, and ``upsample_argmax`` takes the one (stride-32
  logits -> height) operator of the launch. The opt-in
  ``PredictConfig.effnet_bucket_heights`` pads them up to the height
  bucket by replicating the last row (approximate, see config.py);
- ``PREFETCH`` chunks are in flight on a worker pool, each doing decode ->
  pad -> upload -> device step -> pull; the caller's thread runs the
  native union-find postprocess (remove_small_zones + exclude_nodes remap
  + class counts, io/native.py) and hands the maps to the artifact writer
  (pipeline/report.py). Without the native library (io/native.py) it
  unpacks the maps in numpy, runs ops/ccl.remove_small_zones_ragged on the
  engine's device and the remap in numpy, and the report counts the
  classes itself, as the JAX package does.

Checkpoints: a reference ``best_model.pt`` (torchvision-named state dict)
or weights carried across from the JAX package with
models/convert.variables_to_state_dict and saved as ``.pt``; or the
port's offline int8 checkpoint (models/quantize.py, ``*.int8.pt``), which
starts the engine quantized.

A mesh (``mesh=``, parallel/distributed.make_mesh; JAX's ``(data,
model)`` mesh): every rank plans the same chunks (checked by a digest
of the plan, gathered from every rank) and reads the whole chunk from
disk; a launch batch is padded to a multiple of the data size and each
rank uploads its rows (``data``) and its strip of the width (``model``)
with the stem's halo of 3 + 2 columns. The backbone and head exchange
halos (parallel/spatial.py) and gather the logits to the full width;
``upsample_argmax`` runs at full width on every model rank, as JAX's
``shard_map`` runs it, and the maps are gathered over the data group.
With more than one rank, one pump worker issues every step's
collectives, in chunk order. Grid rank 0 alone postprocesses and writes;
``predict`` returns None on the other ranks. The model axis takes the
dilated ResNets with the FCN or the DeepLab head, in float and in int8
(models/segmentation.check_width_split refuses EfficientNet);
``predict_streaming`` and the server run on one process.

int8 (``PredictConfig.quantize_int8``, opt-in and approximate; JAX
pipeline/predict.py): the first chunk's first images calibrate the folded
model at the engine's dtype before the pump submits any chunk
(``_calibrate_first``; under a mesh on grid rank 0 alone, at full width,
its stats shared with every rank: ``quantize``), then the engine runs the
int8 model
(models/quantize.py): the float stem, cuBLAS int8 GEMMs, float32
requantizing epilogues, float32 logits into ``upsample_argmax``.
"""
from __future__ import annotations

import hashlib
import itertools
import os
import threading
import warnings
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..config import PredictConfig
from ..data.dataset import make_dataset
from ..io.native import image_info, load_image_u8, remove_small_zones_host2
from ..models.convert import (load_jax_checkpoint, load_state_dict_into,
                              load_torch_checkpoint)
from ..models.fold import fold_model
from ..models.quantize import (calibrate, check_quantizable,
                               is_jax_quantized_checkpoint,
                               is_quantized_checkpoint, load_jax_quantized,
                               load_quantized, quantize_model, stat_paths,
                               state_digest)
from ..models.resnet import row_mask
from ..models.segmentation import MODEL_FACTORIES, check_width_split
from ..ops.ccl import remove_small_zones_ragged
from ..ops.resize import column_operator_t, embedded_bicubic_rows
from ..ops.upsample_argmax import column_windows, upsample_argmax
from ..parallel.distributed import (Mesh, make_mesh, pad_to_multiple,
                                    single_process)
from ..parallel.spatial import is_split, stem_columns, stem_edge_pads
from ..utils.device import resolve_device, set_float32_exact
from ..utils.profiling import stage_timer
from .preprocess import ProcessedImage
from .report import PredictReporter


# chunks in flight in the predict pump
PREFETCH = 2
# images of the first chunk that the lazy int8 calibration runs on
CALIBRATION_IMAGES = 4


class NeuralBarkCalculator:
    """Folder predictor with the reference's public surface
    (models.py:212-245): ``NeuralBarkCalculator(model_path).predict(root,
    exclude_nodes)``.

    ``device``: ``"cuda"`` (the default) runs on the card and raises when
    there is none; ``"cpu"`` runs the same path on the CPU, where the
    kernel's plain version stands in for it.

    ``mesh``: this rank's place in a ``(data, model)`` grid of processes
    (parallel/distributed.make_mesh; JAX's ``mesh=``). None is the 1x1
    mesh of one process, which issues no collective.
    """

    def __init__(self, model_path: str,
                 config: PredictConfig | None = None,
                 model_name: str = "fcn_resnet50",
                 device: str | torch.device = "cuda", *,
                 mesh: Mesh | None = None):
        self.device = resolve_device(device)
        self.config = config or PredictConfig(model_path=model_path)
        self.mesh = (mesh if mesh is not None
                     else make_mesh(world=single_process(self.device)))
        if model_name not in MODEL_FACTORIES:
            raise ValueError(f"unknown model {model_name!r} (the zoo: "
                             f"{sorted(MODEL_FACTORIES)})")
        self.dtype = (torch.bfloat16 if self.config.use_bfloat16
                      else torch.float32)
        if self.dtype == torch.float32:
            set_float32_exact(self.device)
        self._quantize_pending = False
        self._quant_lock = threading.Lock()
        kind = _load_checkpoint_kind(model_path)
        if kind in ("int8", "jax_int8"):
            # an offline int8 checkpoint: no folding, no calibration
            load = load_quantized if kind == "int8" else load_jax_quantized
            self.model = load(model_path, model_name).to(self.device)
            self._check_int8_state()
        else:
            model = MODEL_FACTORIES[model_name]()
            if self.config.quantize_int8:
                check_quantizable(model)  # raises for EfficientNet
            if is_split(self.mesh.model):
                check_width_split(model)  # before reading the weights
            load_state_dict_into(model, (
                load_torch_checkpoint(model_path) if kind == "float"
                else load_jax_checkpoint(model_path, model_name)))
            # constant-fold eval-mode BatchNorm into the conv weights and
            # biases
            model = fold_model(model)
            if self.config.quantize_int8:
                # int8 calibrates on the first chunk (_calibrate_first);
                # until then keep the folded float32 weights on the host
                self._host_state = {k: v.detach() for k, v in
                                    model.state_dict().items()}
                self._quantize_pending = True
            # bf16 runs channels_last, cuDNN's fast layout; an NHWC batch
            # viewed as NCHW already has that layout
            fmt = (torch.channels_last if self.dtype == torch.bfloat16
                   else torch.contiguous_format)
            self.model = model.to(device=self.device, dtype=self.dtype,
                                  memory_format=fmt).eval()
        # exact-height backbones (EfficientNet): one launch height per
        # distinct trimmed height, or per bucket with effnet_bucket_heights
        backbone = self.model.backbone
        self._exact_heights = not backbone.supports_ragged
        self._bucketed_exact = (self._exact_heights
                                and self.config.effnet_bucket_heights)
        if self._bucketed_exact and \
                self.config.height_bucket % backbone.feature_stride:
            raise ValueError(
                f"effnet_bucket_heights: height_bucket "
                f"{self.config.height_bucket} must be a multiple of the "
                f"backbone's feature stride {backbone.feature_stride} (the "
                f"TF-SAME padding phase is only height-invariant on stride "
                f"multiples)")
        self.mean = torch.tensor(self.config.mean, dtype=torch.float32,
                                 device=self.device)
        self.std = torch.tensor(self.config.std, dtype=torch.float32,
                                device=self.device)
        self._cache_stats = {"launch_shapes": 0, "rowop_evictions": 0,
                             "bytes_h2d": 0}
        self._launch_shapes: set[tuple[int, int, int]] = set()
        self._stats_lock = threading.Lock()
        # device-resident per-height row operators, keyed (h, pad_h), and
        # the shared width operators, keyed (Wf, W); the lock serializes
        # misses from concurrent pump workers
        self._rowop_cache: dict[tuple[int, int], torch.Tensor] = {}
        self._colt_cache: dict[tuple[int, int],
                               tuple[torch.Tensor, torch.Tensor]] = {}
        self._cache_lock = threading.Lock()

    def _bucket_of(self, h: int) -> int:
        if self._exact_heights:  # fixed_pad_height does not apply
            if self._bucketed_exact:
                return pad_to_multiple(h, self.config.height_bucket)
            return h
        fixed = self.config.fixed_pad_height
        if fixed and h <= fixed:
            # one pinned launch height (exact through the row masks)
            # instead of a content-dependent bucket nobody warmed
            return fixed
        return pad_to_multiple(h, self.config.height_bucket)

    # ------------------------------------------------------------- public

    def predict(self, root_path: str, exclude_nodes: bool = False,
                images: Sequence[ProcessedImage] | None = None,
                progress: bool = True, resume: bool = False,
                shard: tuple[int, int] | None = None) -> str | None:
        """Predict every image under root/processed, writing results/
        artifacts (combined figures, dual PNGs, final_stats.csv). Returns
        the csv path.

        ``images`` short-circuits re-reading the PNGs when the caller just
        preprocessed them in the same process. Without it, image sizes
        come from file headers and each chunk is decoded just in time on
        the pump's workers, so folder size never bounds host memory.

        ``resume``: images whose dual PNG and combined figure already
        exist are not predicted again; their CSV row is rebuilt from the
        dual mask on disk, so an interrupted run finishes with a complete
        final_stats.csv.

        ``shard=(k, n)``: predict only the manifest indices i with
        i % n == k (round-robin, so every shard gets its share of each
        height bucket) and write the per-shard CSV instead
        (``PredictReporter.finalize``); returns its path. A resumed shard
        rebuilds only its own rows. pipeline/multihost.py runs the shards
        and merges them.

        Under a mesh every rank calls this with the same arguments; grid
        rank 0 writes and returns the path, the other ranks return None.
        """
        if shard is not None and not 0 <= shard[0] < shard[1]:
            raise ValueError(f"shard {shard[0]}/{shard[1]}: need "
                             f"0 <= k < n")
        processed_path = os.path.join(root_path, "processed")
        reporter = self._reporter(root_path)
        if images is None:
            records = make_dataset(processed_path)
            names = [(r.fname, r.wood_type) for r in records]

            def size_of(i: int) -> tuple[int, int]:
                return _header_size(records[i].sample_path)

            def decode_chunk(idxs):
                return [ProcessedImage(
                    load_image_u8(records[i].sample_path),
                    records[i].fname, records[i].wood_type) for i in idxs]
        else:
            names = [(im.fname, im.wood_type) for im in images]

            def size_of(i: int) -> tuple[int, int]:
                return images[i].image.shape[:2]

            def decode_chunk(idxs):
                return [images[i] for i in idxs]

        mine = (range(len(names)) if shard is None
                else range(shard[0], len(names), shard[1]))
        done = (self._scan_resume(names, reporter, only=mine) if resume
                else set())
        chunks = self._plan_chunks([(i, *size_of(i)) for i in mine
                                    if i not in done])
        # also a barrier: no rank writes before every rank has scanned
        self._check_plan(names, chunks)
        if not self.mesh.is_main:
            for _ in self._run_chunks(chunks, decode_chunk, exclude_nodes,
                                      postprocess=False):
                pass
            return None
        bar = _progress_bar(progress, sum(len(c[1]) for c in chunks))
        for idx, item, cmap, counts3 in self._run_chunks(
                chunks, decode_chunk, exclude_nodes):
            reporter.add(item.image, cmap, item.fname, item.wood_type,
                         order=idx, counts3=counts3)
            if bar is not None:
                bar.update(1)
        if bar is not None:
            bar.close()
        return reporter.finalize(shard=shard)

    def predict_images(self, images: Sequence[ProcessedImage],
                       exclude_nodes: bool = False,
                       with_counts: bool = False):
        """Yield (ProcessedImage, class_map[h, w] uint8) for each image, in
        batched bucket order. ``with_counts=True`` yields (item,
        class_map, counts3) instead, counts3 being the int64 [3] per-class
        pixel count the native postprocess already produced (counted here
        without the native library). Under a mesh every rank calls this
        with the same images and yields every map."""
        chunks = self._plan_chunks(
            [(i, *im.image.shape[:2]) for i, im in enumerate(images)])
        self._check_plan([(im.fname, im.wood_type) for im in images],
                         chunks)
        for _, item, cmap, counts in self._run_chunks(
                chunks, lambda idxs: [images[i] for i in idxs],
                exclude_nodes):
            if not with_counts:
                yield item, cmap
                continue
            if counts is None:
                counts = np.bincount(cmap.ravel(), minlength=3)
            yield item, cmap, counts

    def predict_streaming(self, root_path: str, stream,
                          exclude_nodes: bool = False,
                          total: int | None = None,
                          progress: bool = True) -> str:
        """Full-pipeline fusion: consume a live (manifest_idx,
        ProcessedImage) stream (Preprocessor.preprocess_stream) and feed
        the pump as images arrive, so preprocess and predict overlap, with
        at most (open buckets x batch_size) images buffered in the planner
        plus ``PREFETCH`` chunks in flight. CSV rows land in manifest
        order through the stream's indices: the output equals the
        sequential path's. One process only: each rank's plan would
        depend on when its files arrive."""
        import queue as _queue

        if self.mesh.n_devices > 1:
            raise ValueError("predict_streaming runs on one process: its "
                             "plan depends on when each rank's files "
                             "arrive")

        reporter = self._reporter(root_path)
        bs = self.config.batch_size
        chunk_q: _queue.Queue = _queue.Queue(
            maxsize=PREFETCH)
        items_by_idx: dict[int, ProcessedImage] = {}
        items_lock = threading.Lock()
        planner_err: list[BaseException] = []

        def planner() -> None:
            pending: dict[tuple[int, int], list[int]] = {}
            try:
                for idx, item in stream:
                    with items_lock:
                        items_by_idx[idx] = item
                    key = (self._bucket_of(item.image.shape[0]),
                           item.image.shape[1])
                    group = pending.setdefault(key, [])
                    group.append(idx)
                    if len(group) == bs:
                        chunk_q.put((key[0], pending.pop(key)))
                for (pad_h, _w), idxs in sorted(pending.items()):
                    chunk_q.put((pad_h, idxs))
            except BaseException as e:  # re-raised by the consumer
                planner_err.append(e)
            finally:
                chunk_q.put(None)

        def take_items(idxs):
            with items_lock:
                return [items_by_idx.pop(i) for i in idxs]

        def chunk_iter():
            while True:
                c = chunk_q.get()
                if c is None:
                    if planner_err:
                        raise planner_err[0]
                    return
                yield c

        t = threading.Thread(target=planner, daemon=True)
        t.start()
        bar = _progress_bar(progress and bool(total), total)
        for idx, item, cmap, counts3 in self._run_chunks(
                chunk_iter(), take_items, exclude_nodes):
            reporter.add(item.image, cmap, item.fname, item.wood_type,
                         order=idx, counts3=counts3)
            if bar is not None:
                bar.update(1)
        t.join()
        if bar is not None:
            bar.close()
        return reporter.finalize()

    def cache_stats(self) -> dict:
        """Telemetry: ``launch_shapes`` counts distinct (pad_h, batch,
        width) device-step shapes run (on the exact-height path, one
        pad_h per distinct height); ``rowop_evictions`` counts row
        operators dropped from the 128-entry device cache; ``bytes_h2d``
        counts host->device pixel bytes, dummy rows of the pow2 ladder
        included."""
        with self._stats_lock:
            return dict(self._cache_stats)

    def launch_item_counts(self) -> list[int]:
        """One representative item count per distinct launch-batch size:
        feeding the engine each of these covers every batch shape a
        micro-batch of 1..batch_size items can hit."""
        reps: dict[int, int] = {}
        for n in range(1, self.config.batch_size + 1):
            reps.setdefault(self._padded_batch(n), n)
        return sorted(reps.values())

    # --------------------------------------------------- unified engine

    def _reporter(self, root_path: str) -> PredictReporter:
        return PredictReporter(os.path.join(root_path, "results"),
                               dpi=self.config.figure_dpi,
                               mm_per_pix=self.config.mm_per_pix,
                               renderer=self.config.renderer)

    def _scan_resume(self, names: list[tuple[str, str]],
                     reporter: PredictReporter,
                     only: Sequence[int] | None = None) -> set[int]:
        """Rebuild the CSV rows of images whose dual PNG and combined
        figure already exist; returns their indices (to skip). ``only``
        restricts the scan to these indices (a shard's: a resumed shard
        must not take other shards' rows into its CSV)."""
        done: set[int] = set()
        for i in range(len(names)) if only is None else only:
            fname, wood_type = names[i]
            dual_path = os.path.join(reporter.results_dir, "outputs",
                                     wood_type, fname)
            fig_path = os.path.join(reporter.results_dir, "combined_images",
                                    wood_type, fname)
            if os.path.isfile(dual_path) and os.path.isfile(fig_path):
                dual = load_image_u8(dual_path, grayscale=True)
                reporter.add_row_only(
                    ((dual == 127) * 1 + (dual == 255) * 2).astype(
                        np.uint8), fname, wood_type, order=i)
                done.add(i)
        return done

    def _plan_chunks(self, sizes: list[tuple[int, int, int]]
                     ) -> list[tuple[int, list[int]]]:
        """(index, trimmed height, width) triples -> [(pad_h, [index...])]:
        group into (height bucket, width) shapes, split into batch-size
        chunks. Same-height images of different widths never share a
        chunk."""
        buckets: dict[tuple[int, int], list[int]] = {}
        for i, h, w in sizes:
            buckets.setdefault((self._bucket_of(h), w), []).append(i)
        bs = self.config.batch_size
        return [(pad_h, idxs[s:s + bs])
                for (pad_h, _w), idxs in sorted(buckets.items())
                for s in range(0, len(idxs), bs)]

    def _check_plan(self, names: list[tuple[str, str]],
                    chunks: list[tuple[int, list[int]]]) -> None:
        """Under a mesh of more than one rank: gather a digest of the
        images' names and the planned chunks from every rank and raise
        unless they agree (every rank must launch the same steps, or the
        collectives pair up wrong). Reading the digests back waits for
        every rank."""
        if self.mesh.n_devices == 1:
            return
        self._check_agree(
            hashlib.sha256(repr((names, chunks)).encode()).digest(),
            "planned different chunks (images or their sizes differ "
            "between them)")

    def _check_int8_state(self) -> None:
        """Under a mesh of more than one rank: raise unless every rank's
        int8 weights and scales are the same, bit for bit (a digest of the
        state dict, gathered from every rank)."""
        if self.mesh.n_devices > 1:
            self._check_agree(state_digest(self.model),
                              "hold different int8 weights or scales")

    def _check_agree(self, digest: bytes, differ: str) -> None:
        """Gather ``digest`` from every rank of the mesh and raise unless
        they are equal; reading them back waits for every rank."""
        mine = torch.tensor(list(digest), dtype=torch.uint8,
                            device=self.device)
        every = self.mesh.world.gather_rows(mine[None]).cpu()
        if not bool((every == every[0]).all()):
            raise RuntimeError(f"rank {self.mesh.world.rank}: the ranks "
                               f"{differ}")

    def _run_chunks(self, chunks, decode_chunk, exclude_nodes: bool,
                    postprocess: bool = True):
        """The pump: each chunk's round trip (decode -> pad -> upload ->
        device step -> pull) runs as one worker task, ``PREFETCH`` chunks
        in flight, consumed in submission order; the caller's thread
        postprocesses and yields (index, ProcessedImage, class_map,
        counts3), or nothing without ``postprocess``. The workers share
        the current CUDA stream, so the device runs the steps in
        submission order. Under a mesh of more than one rank a single
        worker runs the tasks, so every rank issues its collectives in
        chunk order from one thread."""
        it = iter(chunks)
        if self._quantize_pending:
            # int8 calibration needs real pixels before the first step
            first = next(it, None)
            if first is None:
                return
            decode_chunk = self._calibrate_first(*first, decode_chunk)
            it = itertools.chain([first], it)

        def pump_one(pad_h, idxs):
            items = decode_chunk(idxs)
            valid_h, out = self._launch_batch(items, pad_h)
            return items, valid_h, out

        workers = PREFETCH if self.mesh.n_devices == 1 else 1
        with ThreadPoolExecutor(max_workers=workers) as pool:
            window: deque = deque()

            def submit_next() -> bool:
                try:
                    pad_h, idxs = next(it)
                except StopIteration:
                    return False
                window.append((idxs, pool.submit(pump_one, pad_h, idxs)))
                return True

            for _ in range(PREFETCH):
                if not submit_next():
                    break
            while window:
                idxs, fut = window.popleft()
                items, valid_h, out = fut.result()
                submit_next()
                if postprocess:
                    yield from self._finish_batch_raw(exclude_nodes, idxs,
                                                      items, valid_h, out)

    def _calibrate_first(self, pad_h: int, idxs: list[int], decode_chunk):
        """Lazy int8 calibration (PredictConfig.quantize_int8) on the first
        chunk, before the pump submits any: up to CALIBRATION_IMAGES of its
        images, decoded once, as one batch zero-padded to the chunk's
        height and run without row masks (the padded rows only make the
        scales a little conservative). Returns ``decode_chunk`` serving
        those images from memory, so the pump does not decode them again
        (a decode that pops its items, as the streaming path's, works as
        well)."""
        with self._quant_lock:
            if not self._quantize_pending:  # another caller calibrated
                return decode_chunk
            head = idxs[:CALIBRATION_IMAGES]
            items = decode_chunk(head)
            self.quantize([items], pad_h)
        memo = dict(zip(head, items))

        def decode(chunk_idxs):
            got = {i: memo.pop(i) for i in chunk_idxs if i in memo}
            missing = [i for i in chunk_idxs if i not in got]
            if missing:
                got.update(zip(missing, decode_chunk(missing)))
            return [got[i] for i in chunk_idxs]
        return decode

    def quantize(self, groups: Sequence[Sequence[ProcessedImage]],
                 pad_h: int | None = None) -> None:
        """Calibrate int8 on ``groups`` of images (each group one batch,
        zero-padded to ``pad_h`` or its tallest image, normalized as the
        device step normalizes, run at the engine's dtype on its device
        without row masks), quantize the folded float32 host weights and
        swap the engine to the int8 model; the host copy is freed. Needs
        ``quantize_int8`` and no calibration yet.

        Under a mesh every rank calls this with the same images: grid rank
        0 alone calibrates, at full width with no split, as one process
        does (JAX calibrates once, on the host); its stats reach every
        rank as one float64 vector in ``stat_paths`` order, each rank
        quantizes its own host weights with them, and a gathered digest
        of the int8 state dicts checks that every rank holds the same."""
        if not self._quantize_pending:
            raise RuntimeError("quantize: the engine is not waiting for an "
                               "int8 calibration (quantize_int8 off, an "
                               "int8 checkpoint, or calibrated already)")
        world = self.mesh.world
        with stage_timer("predict/quantize_calibration"):
            stats = (calibrate(self.model, self._calibration_batches(
                groups, pad_h)) if world.is_main else None)
            if world.size > 1:
                paths = stat_paths(self.model)
                mine = torch.tensor(
                    [stats[p] for p in paths] if stats is not None
                    else [0.0] * len(paths),
                    dtype=torch.float64, device=self.device)
                stats = dict(zip(paths, world.gather_rows(
                    mine[None])[0].tolist()))  # rank 0's
            qmodel = quantize_model(self.model, stats=stats,
                                    folded_state=self._host_state)
        self.model = qmodel.to(self.device)
        del self._host_state
        self._quantize_pending = False
        self._check_int8_state()

    def _calibration_batches(self, groups, pad_h: int | None
                             ) -> list[torch.Tensor]:
        """``quantize``'s groups as normalized NHWC batches at the
        engine's dtype on its device."""
        batches = []
        for items in groups:
            height = pad_h or max(it.image.shape[0] for it in items)
            batch = np.zeros((len(items), height, items[0].image.shape[1],
                              3), np.uint8)
            for i, it in enumerate(items):
                batch[i, :it.image.shape[0]] = it.image
            vh = torch.tensor([it.image.shape[0] for it in items],
                              dtype=torch.int32, device=self.device)
            x = self._normalize(torch.from_numpy(batch).to(self.device), vh)
            batches.append(x.to(self.dtype))
        return batches

    def _finish_batch_raw(self, exclude_nodes, chunk_idxs, items, valid_h,
                          out):
        if out.shape[0] > len(items):  # drop pow2-ladder dummy rows
            out = out[:len(items)]
            valid_h = valid_h[:len(items)]
        pad_h = out.shape[1]
        w = items[0].image.shape[1]
        packed = out.shape[2] != w  # 2-bit packed device pull
        with stage_timer(f"predict/postprocess_h{pad_h}"):
            # one native pass: unpack + remove_small_zones + exclude_nodes
            # remap + per-class counts
            res = remove_small_zones_host2(
                out, w, valid_h, packed=packed, exclude_nodes=exclude_nodes)
            if res is not None:
                out, counts = res
            else:  # no native library: numpy unpack + the device CCL
                if packed:
                    out = _UNPACK2[out].reshape(out.shape[0], out.shape[1],
                                                -1)
                out = self._postprocess(out, valid_h, exclude_nodes)
                counts = None
        for i, (idx, item) in enumerate(zip(chunk_idxs, items)):
            yield (idx, item, out[i, :item.image.shape[0]],
                   None if counts is None else counts[i])

    def _postprocess(self, preds_u8: np.ndarray, valid_h: np.ndarray,
                     exclude_nodes: bool) -> np.ndarray:
        """remove_small_zones + exclude_nodes remap (models.py:270-276)
        without the native library: ops/ccl.remove_small_zones_ragged on
        the engine's device over each image's valid rows, the remap in
        numpy."""
        _warn_no_native()
        cleaned = remove_small_zones_ragged(
            torch.from_numpy(preds_u8).to(self.device),
            torch.from_numpy(np.asarray(valid_h, np.int32))).cpu().numpy()
        if exclude_nodes:  # node class 2 -> 1 (models.py:273-276)
            cleaned = np.where(cleaned == 2, 1, cleaned).astype(np.uint8)
        return cleaned

    # ------------------------------------------------------------ internal

    def _pad_group(self, items: Sequence[ProcessedImage], pad_h: int,
                   n_pad: int) -> np.ndarray:
        """[n_pad, pad_h, w, 3] uint8 from trimmed images: pad rows and
        the dummy rows past len(items) are zero (the zero-beyond-valid_h
        invariant the masking relies on); with effnet_bucket_heights the
        pad rows replicate each image's last row instead. Only the padding
        is filled."""
        w = items[0].image.shape[1]
        buf = np.empty((n_pad, pad_h, w, 3), np.uint8)
        for i, item in enumerate(items):
            h = item.image.shape[0]
            buf[i, :h] = item.image
            buf[i, h:] = item.image[h - 1] if self._bucketed_exact else 0
        buf[len(items):] = 0
        return buf

    def _padded_batch(self, n: int) -> int:
        """Launch-batch size for ``n`` items: rounded up the
        {1,2,4,...,batch_size} ladder with dummy rows, so a folder tail or
        a micro-batch of any size hits one of a few launch shapes, then to
        a multiple of the mesh's data size (JAX pipeline/predict.py:639);
        dummy rows are dropped before postprocess."""
        bs = self.config.batch_size
        if 0 < n < bs:
            p = 1
            while p < n:
                p *= 2
            n = min(p, bs)
        return pad_to_multiple(n, self.mesh.data_size)

    def _launch_batch(self, items: list[ProcessedImage], pad_h: int
                      ) -> tuple[np.ndarray, np.ndarray]:
        """Pad a bucket chunk, run the device step and pull the maps.
        Returns (valid_h [n_pad] int32, class maps [n_pad, pad_h, w or
        w/4] uint8) on the host; rows past len(items) are dummies. Under a
        mesh the rank uploads its rows and columns (with the stem's halo)
        and gets every rank's maps.

        Exact heights: the model runs on the batch as it is, without row
        masks, and every image takes the launch height's operator; valid_h
        still carries the true heights, so the postprocess crops the
        effnet_bucket_heights pad rows."""
        exact = self._exact_heights
        if exact and not self._bucketed_exact:
            assert all(it.image.shape[0] == pad_h for it in items)
        if not exact and pad_h % 8:
            raise ValueError(
                f"height bucket {pad_h} must be a multiple of 8 (the "
                f"model's output stride); set PredictConfig.height_bucket "
                f"accordingly")
        n = len(items)
        n_pad = self._padded_batch(n)
        w = items[0].image.shape[1]
        valid_h = np.array([it.image.shape[0] for it in items]
                           + [items[0].image.shape[0]] * (n_pad - n),
                           np.int32)
        rows = self.mesh.data.rank_slice(n_pad)
        cols = (stem_columns(w, self.mesh.model)
                if is_split(self.mesh.model) else slice(None))
        batch = np.ascontiguousarray(
            self._pad_group(items, pad_h, n_pad)[rows, :, cols])
        # dummies reuse image 0's operator
        ops = [self._row_op_dev(pad_h if exact else int(h), pad_h)
               for h in valid_h[rows]]
        with self._stats_lock:
            self._launch_shapes.add((pad_h, n_pad, w))
            self._cache_stats["launch_shapes"] = len(self._launch_shapes)
            self._cache_stats["bytes_h2d"] += batch.nbytes
        with stage_timer(f"predict/dispatch_h{pad_h}"), \
                torch.inference_mode():
            x = torch.from_numpy(batch).to(self.device)
            vh = None if exact else torch.from_numpy(valid_h[rows]).to(
                self.device)
            out = self._device_step(x, vh, torch.stack(ops),
                                    pack=w % 4 == 0)
        with stage_timer(f"predict/pull_h{pad_h}"):
            out = out.cpu().numpy()  # waits for the device step
        return valid_h, out

    def _row_op_dev(self, h: int, pad_h: int) -> torch.Tensor:
        """The embedded (feat_h -> h) bicubic row operator for one trimmed
        height, uploaded once and cached on the device. On the exact-height
        path (h == pad_h) it is the plain (ceil(pad_h / stride) -> pad_h)
        operator: the model sees the launch height itself."""
        key = (h, pad_h)
        with self._cache_lock:
            op = self._rowop_cache.get(key)
            if op is None:
                backbone = self.model.backbone
                if self._exact_heights:
                    feat_h = pad_feat = -(-pad_h // backbone.feature_stride)
                else:
                    feat_h = backbone.valid_feature_height(h)
                    pad_feat = pad_h // 8
                op = torch.from_numpy(embedded_bicubic_rows(
                    feat_h, h, pad_feat, pad_h)).to(self.device)
                if len(self._rowop_cache) >= 128:  # bound: 128 x 512 KB
                    self._rowop_cache.pop(next(iter(self._rowop_cache)))
                    with self._stats_lock:
                        self._cache_stats["rowop_evictions"] += 1
                self._rowop_cache[key] = op
        return op

    def _colt_dev(self, wf: int, w: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
        """The transposed (wf -> w) width operator and its column windows
        (``column_windows``), computed once and cached on the device."""
        with self._cache_lock:
            op = self._colt_cache.get((wf, w))
            if op is None:
                colt = torch.from_numpy(column_operator_t(wf, w)).to(
                    self.device)
                op = (colt, column_windows(colt))
                self._colt_cache[(wf, w)] = op
        return op

    def _device_step(self, batch_u8: torch.Tensor,
                     valid_h: torch.Tensor | None, row_ops: torch.Tensor,
                     pack: bool) -> torch.Tensor:
        """[B, pad_h, W, 3] uint8 -> class maps [B, pad_h, W] uint8, or
        [B, pad_h, W/4] 2-bit packed, on the device. ``valid_h`` None:
        the exact-height path (no row masks). Under a mesh: the rank's
        rows and strip (``_launch_batch``) -> every rank's maps at the
        full width."""
        feat = self._logits(batch_u8, valid_h)
        w = batch_u8.shape[2]
        if is_split(self.mesh.model):
            # the logits are the full width's; the split backbone's
            # feature stride divides the image width
            w = feat.shape[2] * self.model.backbone.feature_stride
        preds = upsample_argmax(feat, row_ops,
                                *self._colt_dev(feat.shape[2], w))
        return self.mesh.data.gather_rows(pack2bit(preds) if pack
                                          else preds)

    def _logits(self, batch_u8: torch.Tensor,
                valid_h: torch.Tensor | None) -> torch.Tensor:
        """[B, pad_h, W, 3] uint8 -> float32 head logits at the feature
        stride [B, F, Wf, 3], in the engine's dtype and layout. Under a
        mesh that splits the width, ``batch_u8`` is the rank's strip with
        the stem's halo clipped to the image, and the logits are the full
        width's."""
        x = self._normalize(batch_u8, valid_h)
        width = self.mesh.model
        if is_split(width):
            # the stem's zero padding past the image's edges, after the
            # normalization (as the rows past valid_h)
            x = F.pad(x, (0, 0, *stem_edge_pads(width)))
        return self.model.head_logits(x.to(self.dtype), valid_h,
                                      width=width)

    def _normalize(self, batch_u8: torch.Tensor,
                   valid_h: torch.Tensor | None) -> torch.Tensor:
        """[B, pad_h, W, 3] uint8 -> normalized float32, zero past each
        image's valid rows."""
        x = batch_u8.float() / 255.0
        x = (x - self.mean) / self.std
        if valid_h is not None:
            # normalization turns the zero-padded rows into -mean/std;
            # re-zero them: the ragged exactness needs the input zero
            # beyond valid_h, matching the reference's per-image conv zero
            # padding
            x = x * row_mask(valid_h, x.shape[1], x.dtype).view(
                x.shape[0], x.shape[1], 1, 1)
        return x


# the host's inverse of pack2bit: byte -> its 4 pixels (JAX
# pipeline/predict.py's _UNPACK2)
_UNPACK2 = np.stack([(np.arange(256, dtype=np.uint8) >> (2 * k)) & 3
                     for k in range(4)], axis=1)

_no_native_lock = threading.Lock()
_no_native_warned = False


def _warn_no_native() -> None:
    """The JAX package's warning for the postprocess without the native
    library, once a process."""
    global _no_native_warned
    with _no_native_lock:
        if _no_native_warned:
            return
        _no_native_warned = True
    warnings.warn(
        "native/libbarkio.so is not built: remove_small_zones is falling "
        "back to the device CCL (ops/ccl), and the class counts to numpy. "
        "Run `make -C native` to build the C++ runtime.", RuntimeWarning,
        stacklevel=3)


def pack2bit(m: torch.Tensor) -> torch.Tensor:
    """[B, H, W] uint8 {0,1,2} -> [B, H, W//4] uint8, 4 pixels per byte
    (pixel k of each group in bits 2k..2k+1): a quarter of the bytes to
    pull to the host."""
    m4 = m.view(m.shape[0], m.shape[1], -1, 4)
    return (m4[..., 0] | (m4[..., 1] << 2) | (m4[..., 2] << 4)
            | (m4[..., 3] << 6))


def _progress_bar(enabled: bool, total: int | None):
    if not enabled:
        return None
    try:
        from tqdm import tqdm
    except ImportError:  # pragma: no cover
        return None
    return tqdm(total=total, ascii=True, desc="Predicted images")


def _header_size(path: str) -> tuple[int, int]:
    """Image (height, width) from the file header alone (no pixel
    decode); PIL for formats the native runtime does not read."""
    info = image_info(path)
    if info is not None:
        return info[0], info[1]
    from PIL import Image
    with open(path, "rb") as f:
        w, h = Image.open(f).size  # lazy: header only
    return h, w


def _load_checkpoint_kind(path: str) -> str:
    """What ``path`` holds, as the JAX engine's loaders tell it: "int8"
    for the port's offline int8 checkpoint, "jax_int8" for the JAX
    package's (its NBCQINT8 tag), "float" for a ``.pt`` / ``.pth`` state
    dict, "jax_float" for an orbax directory or a flax ``.msgpack``
    (anything else); raises for a missing path."""
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"model checkpoint not found: {path!r} (expected a reference "
            f"best_model.pt, a flax .msgpack file, or an orbax directory; "
            f"the predict CLI looks for ./best_model.pt by default, "
            f"reference predict.py:57)")
    if is_jax_quantized_checkpoint(path):
        return "jax_int8"
    if path.endswith((".pt", ".pth")):
        return "int8" if is_quantized_checkpoint(path) else "float"
    return "jax_float"


__all__ = ["NeuralBarkCalculator", "pack2bit"]
