"""Host-side artifact rendering: combined figures, dual PNGs, stats CSV.

Reproduces the reference's output artifacts byte-layout-compatibly
(reference models.py:263-364):

- ``results/combined_images/<wood_type>/<fname>``: matplotlib side-by-side
  Input / Generated figure with a class legend and an estimated-composition
  suptitle (models.py:280-347). The reference hardcodes dpi=900, which
  dominates its wall-time; ours is configurable (PredictConfig.figure_dpi).
- ``results/outputs/<wood_type>/<fname>``: L-mode PNG, bark=127, node=255
  (models.py:349-356).
- ``results/final_stats.csv``: tab-delimited; the header has 7 columns but
  data rows carry 6 — the reference rebuilds ``running_csv_stats`` without
  the Image Size column (models.py:321 vs 252-255) and we reproduce that
  quirk exactly.

Figure rendering is pure host work, so PredictReporter runs it on a thread
pool that overlaps with device compute. Two renderers:

- ``renderer="fast"`` (default): the first-party raster compositor
  (pipeline/compositor.py), the reference's layout and content without
  matplotlib, which is never imported;
- ``renderer="mpl"``: matplotlib Agg, the reference's own drawing (the
  predict CLI's ``--mpl``). matplotlib is imported only then; without it
  the reporter raises ImportError, with no fallback to the compositor.
  Agg releases the GIL while it rasterizes, so it overlaps on the pool.
"""
from __future__ import annotations

import csv
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..config import CLASS_NAMES, DEFAULT_MM_PER_PIXEL
from ..io.native import save_image_u8
from ..utils.profiling import stage_timer
from .compositor import render_combined_fast

CSV_HEADER = [
    "Name", "Type", "Image Size", "Output Bark %", "Bark area (mm^2)",
    "Output Node %", "Node area (mm^2)",
]


def class_stats_row(fname: str, wood_type: str, counts: np.ndarray,
                    total_pixels: int,
                    mm_per_pix: float = DEFAULT_MM_PER_PIXEL
                    ) -> tuple[list[str], list[float]]:
    """CSV row + percentage list for one image.

    counts: [2] pixel counts for classes (bark, node) over the trimmed
    image; total_pixels = trimmed H*W. Formatting parity with
    models.py:323-332 ('%.5f', area = count * mm_per_pix).
    """
    row = [fname, wood_type]
    percents = []
    for class_idx in (0, 1):
        percent = float(counts[class_idx]) / float(total_pixels) * 100.0
        area = float(counts[class_idx]) * mm_per_pix
        percents.append(percent)
        row.append("{:.5f}".format(percent))
        row.append("{:.5f}".format(area))
    return row, percents


def require_matplotlib() -> None:
    """Raise ImportError with the reason when matplotlib is missing: the
    'mpl' renderer has no fallback."""
    try:
        import matplotlib  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "the matplotlib renderer (--mpl, renderer='mpl') needs "
            "matplotlib, which is not installed here; run without --mpl "
            "for the port's own compositor") from e


def display_subsample(img: np.ndarray, dpi: int) -> np.ndarray:
    """Stride-subsample an image for imshow to ~2x the axes raster size.

    Agg resamples the full-resolution array down to the axes' pixel grid
    while it draws; a >= 2x-oversampled strided view renders the same
    raster at a fraction of the cost. Legend values and CSV percentages
    always come from the full-resolution map."""
    target = max(256, int(4.4 * dpi))
    step = max(1, min(img.shape[0] // target, img.shape[1] // target))
    return img[::step, ::step] if step > 1 else img


def render_figure_mpl(imgs, names, values, suptitle: str, out_path: str,
                      dpi: int) -> None:
    """Panels `imgs` titled `names` side by side, a legend of the class
    `values` of the last 2-D panel, `suptitle` above, drawn by matplotlib
    Agg into a PNG (the reference's drawing, models.py:280-347).
    matplotlib is imported here, and the figure uses the object-oriented
    Figure API: figures render on the reporter's thread pool, and
    pyplot's global figure manager is not thread-safe."""
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.patches as mpatches
    from matplotlib.figure import Figure

    fig = Figure()
    axs = fig.subplots(1, len(imgs))
    patches = []
    for img, name, ax in zip(imgs, names, axs.flatten()):
        plotted = ax.imshow(img, vmax=2)
        ax.set_title(name)
        ax.axis("off")
        if img.ndim == 2:  # a class map: legend of its present values
            patches = [
                mpatches.Patch(
                    color=plotted.cmap(plotted.norm(value)),
                    label="{} zone".format(CLASS_NAMES[value]))
                for value in values
            ]
    fig.legend(handles=patches, title="Classes",
               bbox_to_anchor=(0.4, -0.2, 0.5, 0.5))
    fig.suptitle(suptitle)
    try:
        fig.tight_layout()
    except Exception:  # the reference gets the same non-fatal warning
        pass
    fig.savefig(out_path, format="png", dpi=dpi)


def render_combined(input_img: np.ndarray, class_map: np.ndarray,
                    out_path: str, class_percents: list[float],
                    dpi: int = 200) -> None:
    """The side-by-side Input / Generated figure (models.py:280-347),
    drawn by matplotlib Agg (``renderer='mpl'``)."""
    suptitle = "Estimated composition percentages\n"
    for class_name, class_percent in zip(CLASS_NAMES[1:], class_percents):
        suptitle += "{} : {:.3f}\n".format(class_name, class_percent)
    render_figure_mpl(
        [display_subsample(input_img, dpi), display_subsample(class_map, dpi)],
        ["Input", "Generated image"],
        np.unique(class_map.ravel()),  # full-resolution legend values
        suptitle, out_path, dpi)


def save_dual(class_map: np.ndarray, out_path: str) -> None:
    """Raw mask PNG: bark=127, node=255 (models.py:349-356).

    zlib level 2: masks are long runs of three values — higher levels cost
    ~4x the host time for a few percent smaller files."""
    dual = np.zeros(class_map.shape, dtype=np.uint8)
    dual[class_map == 1] = 127
    dual[class_map == 2] = 255
    save_image_u8(out_path, dual, zlevel=2)


def _timed(stage: str, chunk: int | None, fn, *args) -> None:
    """``fn(*args)`` under the stage timer ``stage``."""
    with stage_timer(stage, chunk):
        fn(*args)


def write_final_stats(rows: list[list[str]], out_path: str) -> None:
    """Tab-delimited final_stats.csv (models.py:360-364)."""
    with open(out_path, "w") as f:
        writer = csv.writer(f, delimiter="\t")
        writer.writerow(CSV_HEADER)
        writer.writerows(rows)


def shard_stats_name(k: int, n: int) -> str:
    """Per-shard CSV file name of shard k of n (sharded folder runs)."""
    return f"final_stats.shard-{k:04d}-of-{n:04d}.csv"


class PredictReporter:
    """Collects per-image results and writes all three artifact kinds,
    offloading figure/PNG encoding to a thread pool. ``renderer``:
    ``"fast"`` (the compositor) or ``"mpl"`` (matplotlib Agg)."""

    def __init__(self, results_dir: str, dpi: int = 200,
                 mm_per_pix: float = DEFAULT_MM_PER_PIXEL,
                 workers: int = 8, renderer: str = "fast"):
        if renderer not in ("fast", "mpl"):
            raise ValueError(f"unknown renderer {renderer!r}")
        if renderer == "mpl":
            require_matplotlib()
        self.results_dir = results_dir
        self.dpi = dpi
        self.mm_per_pix = mm_per_pix
        self.renderer = renderer
        self._rows: list[tuple[int, list[str]]] = []
        self._pool = ThreadPoolExecutor(max_workers=workers)
        self._futures = []
        self._order = 0

    def add(self, input_img: np.ndarray, class_map: np.ndarray,
            fname: str, wood_type: str, order: int | None = None,
            counts3: np.ndarray | None = None,
            chunk: int | None = None) -> None:
        """Render artifacts + record the CSV row. ``order`` fixes the row's
        position in final_stats.csv (the reference writes rows in dataset
        order, models.py:358; batched compute may finish out of order).
        ``counts3``: per-class pixel counts of class_map if the caller
        already has them (the native postprocess counts during its
        write-back sweep — remove_small_zones_host2). The pool's tasks
        run under the stage timers ``report/figure`` and ``report/dual``,
        which carry ``chunk`` (the prediction pump's chunk)."""
        if counts3 is None:
            counts3 = np.bincount(class_map.ravel(), minlength=3)
        percents = self.add_row_only(class_map, fname, wood_type, order,
                                     counts3=counts3)
        combined = os.path.join(self.results_dir, "combined_images",
                                wood_type, fname)
        dual = os.path.join(self.results_dir, "outputs", wood_type, fname)
        if self.renderer == "fast":
            # reuse the class counts: the legend lists present classes
            # only (models.py:298-311) and would otherwise re-count the map
            values = [v for v in range(3) if counts3[v] > 0]
            self._futures.append(self._pool.submit(
                _timed, "report/figure", chunk, render_combined_fast,
                input_img, class_map, combined, percents, self.dpi, values))
        else:
            self._futures.append(self._pool.submit(
                _timed, "report/figure", chunk, render_combined, input_img,
                class_map, combined, percents, self.dpi))
        self._futures.append(self._pool.submit(
            _timed, "report/dual", chunk, save_dual, class_map, dual))

    def add_row_only(self, class_map: np.ndarray, fname: str,
                     wood_type: str, order: int | None = None,
                     counts3: np.ndarray | None = None) -> list[float]:
        """Record the CSV row alone; returns the class percentages."""
        if counts3 is None:
            counts3 = np.bincount(class_map.ravel(), minlength=3)
        counts = np.array([int(counts3[1]), int(counts3[2])])
        row, percents = class_stats_row(
            fname, wood_type, counts, class_map.size, self.mm_per_pix)
        self._rows.append((self._order if order is None else order, row))
        self._order += 1
        return percents

    def finalize(self, shard: tuple[int, int] | None = None) -> str:
        """Write the CSV (and surface any render-worker exception);
        returns its path.

        With ``shard=(k, n)`` the rows go to the per-shard file
        ``shard_stats_name(k, n)``, without a header, each row led by its
        manifest order (the merge key), written to a temporary file and
        renamed into place so a merging process never reads a partial
        one. pipeline/multihost.merge_shard_stats turns the n shard files
        into the final_stats.csv a single-process run writes, byte for
        byte."""
        for fut in self._futures:
            fut.result()  # surface any worker exception
        self._pool.shutdown()
        if shard is None:
            out = os.path.join(self.results_dir, "final_stats.csv")
            write_final_stats([r for _, r in sorted(self._rows)], out)
            return out
        out = os.path.join(self.results_dir, shard_stats_name(*shard))
        tmp = out + ".tmp"
        with open(tmp, "w") as f:
            writer = csv.writer(f, delimiter="\t")
            for order, row in sorted(self._rows):
                writer.writerow([order] + row)
        os.replace(tmp, out)
        return out
