"""First-party raster compositor for the combined Input/Generated figure.

The reference renders its per-image artifact with matplotlib
(models.py:280-347: two imshow panels, a class legend, an
estimated-composition suptitle, savefig at dpi). Agg figure rasterization
is pure host work and measured at ~175 ms/image on a 1-core host — an
order of magnitude more than the device spends producing the class map.
This module draws the same figure directly:

- layout constants are lifted from the real matplotlib figure geometry
  (default 6.4x4.8 in figure, tight_layout'd axes boxes, fig.legend at
  bbox_to_anchor=(0.4,-0.2,0.5,0.5), suptitle y=0.98 — all measured from
  a rendered reference figure and expressed in figure-fraction units so
  any dpi reproduces the same arrangement);
- panels are downsampled with PIL's C resampler (BOX area-average for the
  photo, NEAREST for the categorical map) and the class map is colored
  through the 3-entry viridis LUT that ``imshow(vmax=2)`` uses;
- text (panel titles, legend labels, suptitle) is rasterized with PIL
  FreeType using matplotlib's own DejaVu Sans so glyphs match;
- the canvas encodes through the native PNG encoder (io/native.py).

PIL is imported inside the functions that draw, so importing this module
needs no PIL.

This is the port's only figure path (pipeline/report.py).
"""
from __future__ import annotations

import functools
import os

import numpy as np

from ..config import CLASS_NAMES
from ..io.native import save_image_u8

# viridis at norm(0), norm(1), norm(2) with vmin=0/vmax=2 — the colors
# matplotlib's imshow gives the three classes (and the legend patches).
VIRIDIS3 = np.array([[68, 1, 84], [33, 145, 140], [253, 231, 37]],
                    np.uint8)


def _lut3(vmin: int) -> np.ndarray:
    """Class-value -> color LUT under ``imshow(vmax=2)``.

    The reference never pins vmin (models.py:300), so matplotlib
    autoscales it to the panel's data min and the three classes only get
    the canonical VIRIDIS3 colors when class 0 is present. With
    vmin=1 the norm stretches [1, 2] onto the full colormap (class 1 ->
    viridis(0), class 2 -> viridis(1)); with vmin == vmax == 2 matplotlib's
    Normalize collapses everything to 0. The legend patches are built
    from the same norm (models.py:305-307), so they shift identically."""
    if vmin <= 0:
        return VIRIDIS3
    if vmin == 1:
        return VIRIDIS3[[0, 0, 2]]
    return VIRIDIS3[[0, 0, 0]]

# Figure-fraction layout, measured from the rendered matplotlib figures
# (100 dpi, 640x480 canvas; fractions are dpi-independent). y is from the
# TOP of the canvas. Keyed by panel count: 2 = predict's Input/Generated
# figure, 3 = the eval report's Input/Target/Generated figure.
_FIG_W_IN, _FIG_H_IN = 6.4, 4.8
_LAYOUTS = {
    2: {"x": (0.0234375, 0.51171875), "y": 0.2678,
        "w": 0.46484375, "h": 0.6197917},
    3: {"x": (0.02344, 0.34896, 0.67448), "y": 0.39854,
        "w": 0.30208, "h": 0.40278},
}
_TITLE_GAP_FRAC = 0.009  # gap between title baseline box and axes top
_SUPTITLE_Y = 0.02  # suptitle top (y=0.98 in mpl bottom-origin coords)
# legend anchor: top-right corner of the legend frame sits at the
# upper-right of the bbox_to_anchor box (0.4,-0.2,0.5,0.5), inset by
# ~0.5 em — measured (569, 137)/(640, 480) bottom-origin.
_LEGEND_RIGHT = 0.9, 0.7  # (x_right, y_top from top) before the inset

_TITLE_PT = 12.0
_LEGEND_PT = 10.0


@functools.lru_cache(maxsize=8)
def _font(px: int):
    """DejaVu Sans at a pixel size — matplotlib's bundled font, located
    without importing matplotlib (keeps the fast path mpl-free)."""
    import importlib.util

    from PIL import ImageFont
    try:
        spec = importlib.util.find_spec("matplotlib")
        if spec and spec.submodule_search_locations:
            path = os.path.join(spec.submodule_search_locations[0],
                                "mpl-data", "fonts", "ttf",
                                "DejaVuSans.ttf")
            if os.path.isfile(path):
                return ImageFont.truetype(path, px)
    except Exception:
        pass
    return ImageFont.load_default(size=px)  # PIL >= 10 fallback


def _fit(shape: tuple[int, int], box_w: int, box_h: int
         ) -> tuple[int, int]:
    """Aspect-preserving fit of an image into a panel box (imshow
    aspect='equal')."""
    h, w = shape
    scale = min(box_w / w, box_h / h)
    return max(1, round(w * scale)), max(1, round(h * scale))


def _panel_photo(img: np.ndarray, tw: int, th: int) :
    """Area-downsample the input photo (imshow antialiased resample).

    The full-res photo is first stride-subsampled to >= ~1.5x the
    target raster before the BOX resample. For the pipeline's own <=1024-wide photos the
    pre-pass engages below dpi ~135 — e.g. the dpi-100 bench figure,
    where it cuts the 3 MB panel read ~4x; at the default dpi 200 the
    target raster is already > 2/3 of the source and step stays 1."""
    step = min(img.shape[0] // max(1, round(1.5 * th)),
               img.shape[1] // max(1, round(1.5 * tw)))
    if step > 1:
        img = np.ascontiguousarray(img[::step, ::step])
    from PIL import Image
    return Image.fromarray(img).resize((tw, th), Image.BOX)


def _panel_classmap(cmap: np.ndarray, tw: int, th: int) :
    """NEAREST-downsample the categorical map, then color via the LUT
    (keeps classes crisp; matplotlib interpolates the scalar field, which
    only differs along zone boundaries). The norm's vmin comes from the
    *full-resolution* map (matplotlib autoscales on the data it is given,
    not on the rendered raster), so a rare class surviving only a few
    pixels still anchors the palette."""
    from PIL import Image
    lut = _lut3(int(cmap.min()) if cmap.size else 0)
    small = np.asarray(
        Image.fromarray(cmap).resize((tw, th), Image.NEAREST))
    return Image.fromarray(lut[np.minimum(small, 2)])


@functools.lru_cache(maxsize=16)
def _static_canvas(n_panels: int, titles: tuple[str, ...],
                   dpi: int) :
    """The image-independent figure base — white canvas + panel titles —
    drawn once per (panel count, titles, dpi) and copied per figure. In a
    folder run every figure shares this, so the FreeType work is paid
    once, not per image (the suptitle varies per image and stays
    dynamic; the legend is a cached overlay, ``_legend_patch``)."""
    from PIL import Image, ImageDraw
    layout = _LAYOUTS[n_panels]
    W, H = round(_FIG_W_IN * dpi), round(_FIG_H_IN * dpi)
    canvas = Image.new("RGB", (W, H), "white")
    draw = ImageDraw.Draw(canvas)
    title_f = _font(round(_TITLE_PT / 72 * dpi))
    box_w = round(layout["w"] * W)
    for i, name in enumerate(titles):
        x0 = round(layout["x"][i] * W)
        y0 = round(layout["y"] * H)
        # centered title just above the axes box (mpl pad ~4.3 px@100dpi)
        tb = draw.textbbox((0, 0), name, font=title_f)
        draw.text((x0 + (box_w - (tb[2] - tb[0])) / 2,
                   y0 - _TITLE_GAP_FRAC * H - (tb[3] - tb[1]) - tb[1]),
                  name, font=title_f, fill="black")
    return canvas


def render_figure_fast(panels, titles, suptitle: str,
                       legend_values: list[int], out_path: str,
                       dpi: int = 200) -> None:
    """Generic N-panel figure: photo ([H,W,3]) / class-map ([H,W])
    panels side by side with titles, a centered suptitle block, and the
    class legend (drawn last — it overlays the right panel, matching
    matplotlib's fig.legend z-order). Matches the matplotlib layout for
    2 and 3 panels."""
    from PIL import ImageDraw
    layout = _LAYOUTS[len(panels)]
    W, H = round(_FIG_W_IN * dpi), round(_FIG_H_IN * dpi)
    canvas = _static_canvas(len(panels), tuple(titles), dpi).copy()
    draw = ImageDraw.Draw(canvas, "RGBA")
    title_f = _font(round(_TITLE_PT / 72 * dpi))

    # ---- panels
    box_w, box_h = round(layout["w"] * W), round(layout["h"] * H)
    for i, panel in enumerate(panels):
        x0 = round(layout["x"][i] * W)
        y0 = round(layout["y"] * H)
        tw, th = _fit(panel.shape[:2], box_w, box_h)
        px = x0 + (box_w - tw) // 2
        py = y0 + (box_h - th) // 2
        tile = (_panel_photo(panel, tw, th) if panel.ndim == 3
                else _panel_classmap(panel.astype(np.uint8), tw, th))
        canvas.paste(tile, (px, py))

    # ---- suptitle (centered lines, linespacing 1.2)
    line_h = round(_TITLE_PT / 72 * dpi * 1.2)
    sb = draw.multiline_textbbox((0, 0), suptitle, font=title_f,
                                 spacing=line_h // 4, align="center")
    draw.multiline_text(((W - (sb[2] - sb[0])) / 2, _SUPTITLE_Y * H),
                        suptitle, font=title_f, fill="black",
                        spacing=line_h // 4, align="center")

    # ---- legend overlay (cached RGBA patch, alpha-composited on top —
    # same placement math as the direct draw: frame right edge at
    # _LEGEND_RIGHT x minus a 0.5 em inset, top at _LEGEND_RIGHT y plus)
    patch = _legend_patch(tuple(legend_values), dpi)
    em = _LEGEND_PT / 72 * dpi
    canvas.paste(patch,
                 (round(_LEGEND_RIGHT[0] * W - 0.5 * em) - (patch.width - 1),
                  round(_LEGEND_RIGHT[1] * H + 0.5 * em)), patch)

    # z1: the figure canvas (flat chrome + Sub-filtered panels) compresses
    # as well at level 1 as 2 for less encode time
    save_image_u8(out_path, np.asarray(canvas), zlevel=1)


def render_combined_fast(input_img: np.ndarray, class_map: np.ndarray,
                         out_path: str, class_percents: list[float],
                         dpi: int = 200,
                         legend_values: list[int] | None = None) -> None:
    """The side-by-side Input / Generated figure (models.py:280-347)
    without matplotlib.

    ``legend_values``: present classes if the caller already counted them
    (PredictReporter shares one bincount between CSV and legend)."""
    sup = "Estimated composition percentages\n" + "".join(
        "{} : {:.3f}\n".format(n, p)
        for n, p in zip(CLASS_NAMES[1:], class_percents))
    if legend_values is None:
        # bincount == np.unique for a {0,1,2} uint8 map at ~1/30 the cost
        # (legend lists present classes only, models.py:298-311)
        counts = np.bincount(class_map.ravel(), minlength=3)
        legend_values = [v for v in range(3) if counts[v] > 0]
    render_figure_fast((input_img, class_map), ("Input", "Generated image"),
                       sup.rstrip("\n"), legend_values, out_path, dpi)


@functools.lru_cache(maxsize=16)
def _legend_patch(values: tuple[int, ...], dpi: int):
    """The fig.legend frame as a cached RGBA overlay: 'Classes' title +
    one patch row per present class. Metrics follow matplotlib legend
    defaults in em units (borderpad .4, handlelength 2, handletextpad .8,
    labelspacing .5). Rendered once per (present classes, dpi); callers
    paste it with its own alpha at the _LEGEND_RIGHT anchor."""
    from PIL import Image, ImageDraw
    em = _LEGEND_PT / 72 * dpi
    font = _font(round(em))
    labels = ["{} zone".format(CLASS_NAMES[v]) for v in values]
    entry_h = round(1.0 * em)
    pad = round(0.4 * em)
    handle_w = round(2.0 * em)
    handle_gap = round(0.8 * em)
    spacing = round(0.5 * em)
    title = "Classes"
    # patch colors use the generated panel's autoscaled norm: its data
    # min is exactly the smallest present class (models.py:305-307)
    lut = _lut3(min(values) if values else 0)

    probe = ImageDraw.Draw(Image.new("RGBA", (1, 1)))
    tb = probe.textbbox((0, 0), title, font=font)
    text_w = max((probe.textbbox((0, 0), s, font=font)[2] for s in labels),
                 default=0)
    box_w = 2 * pad + max(handle_w + handle_gap + text_w, tb[2])
    box_h = (2 * pad + entry_h  # title row
             + len(labels) * (entry_h + spacing))

    img = Image.new("RGBA", (box_w + 1, box_h + 1), (0, 0, 0, 0))
    draw = ImageDraw.Draw(img, "RGBA")
    # frame: framealpha .8 white fill, '0.8' gray rounded border
    draw.rounded_rectangle((0, 0, box_w, box_h),
                           radius=round(0.3 * em),
                           fill=(255, 255, 255, 204),
                           outline=(204, 204, 204, 255), width=1)
    # centered title
    draw.text(((box_w - tb[2]) / 2, pad), title, font=font, fill="black")
    y = pad + entry_h + spacing
    for v, label in zip(values, labels):
        hy = y + round(0.12 * em)
        draw.rectangle((pad, hy, pad + handle_w, hy + round(0.75 * em)),
                       fill=tuple(int(c) for c in lut[v]))
        draw.text((pad + handle_w + handle_gap, y), label,
                  font=font, fill="black")
        y += entry_h + spacing
    return img
