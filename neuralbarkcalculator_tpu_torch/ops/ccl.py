"""Connected-component labelling and small-zone removal
(neuralbarkcalculator_tpu/ops/ccl.py), in PyTorch: the CUDA union-find
kernels and their plain version.

Replaces the reference's skimage morphology calls (utils.py:135-148):

    np_image = (img == 0)
    remove_small_holes(np_image, area_threshold=150, connectivity=2)
    remove_small_objects(np_image, min_size=150, connectivity=2)
    img[(np_image == 0) & (img == 0)] = 1   # dropped class-0 islands -> bark
    img[(np_image != 0) & (img != 0)] = 0   # filled holes -> class 0

Every function takes ``[H, W]`` or ``[B, H, W]``; in a batch each image is
labelled on its own. The contract is the JAX package's, bit for bit:

- labels: a foreground pixel holds the per-image flat index (row * W +
  col) of the smallest pixel of its component, int32; background H * W;
- 8-connectivity, for a mask and for its complement;
- remove_small_objects drops a component of area strictly less than
  min_size; remove_small_holes fills a complement component of area
  strictly less than the threshold, with no border exclusion;
- remove_small_zones_ragged sees only each image's first valid_h rows:
  padded rows read as class 0 for the holes step, the objects step is cut
  at valid_h, and padded rows come back 0;
- the class maps keep their dtype.

- On CUDA tensors the wrappers launch the union-find kernels of
  ``csrc/ccl.cu`` (built at first use) or raise: each image labelled in
  tiles of 32 x 128 pixels in shared memory, then the tiles' borders
  merged; 3 launches for label_components, 4 for component_areas and the
  object / hole tests, 7 for remove_small_zones. The kernels read the map
  in place, so a CUDA map must be contiguous.
- Every function takes a map of bool, uint8, int32 or int64, of fewer
  than 2^31 - 1 pixels an image, and raises on anything else.
- On CPU tensors they run the plain version: the JAX package's algorithm
  in torch ops (per sweep a segmented min-scan along rows and along
  columns, each a forward and a reverse Hillis-Steele doubling over
  (value, segment start), then one 8-neighbour min; repeated until a sweep
  changes nothing, at most _MAX_SWEEPS sweeps per image). That is the only
  case the plain version serves.

``LAUNCHES`` counts the wrappers' calls that launched the kernels (one per
call, whatever number of kernels the call runs).
"""
from __future__ import annotations

import torch

from ..config import SMALL_ZONE_THRESHOLD
from .kernels import LaunchCounter, check_launch, kernel_lib

LAUNCHES = LaunchCounter()

_MAX_SWEEPS = 1024  # the JAX package's bound; convergence is checked a sweep
_ELEM_BYTES = {torch.bool: 1, torch.uint8: 1, torch.int32: 4,
               torch.int64: 8}


# ---------------------------------------------------------------- plain


def _shift_scan(v: torch.Tensor, start: torch.Tensor, dim: int
                ) -> torch.Tensor:
    """Inclusive segmented min-scan along ``dim`` by Hillis-Steele
    doubling: combine(left, right) = (right if right starts a segment else
    min(left, right), start_left | start_right)."""
    n = v.shape[dim]
    d = 1
    while d < n:
        lv, ls = v.narrow(dim, 0, n - d), start.narrow(dim, 0, n - d)
        rv, rs = v.narrow(dim, d, n - d), start.narrow(dim, d, n - d)
        v = torch.cat([v.narrow(dim, 0, d),
                       torch.where(rs, rv, torch.minimum(lv, rv))], dim)
        start = torch.cat([start.narrow(dim, 0, d), rs | ls], dim)
        d *= 2
    return v


def _seg_min_scan(lab: torch.Tensor, fg: torch.Tensor, dim: int,
                  sentinel: int) -> torch.Tensor:
    """Min label over each contiguous foreground run along ``dim``: a
    forward and a reverse segmented scan (background cells isolate
    themselves)."""
    n = fg.shape[dim]
    before = torch.zeros_like(fg)
    before.narrow(dim, 1, n - 1).copy_(fg.narrow(dim, 0, n - 1))
    fwd = _shift_scan(lab, ~fg | ~before, dim)
    after = torch.zeros_like(fg)
    after.narrow(dim, 0, n - 1).copy_(fg.narrow(dim, 1, n - 1))
    rev = _shift_scan(lab.flip(dim), (~fg | ~after).flip(dim), dim).flip(dim)
    return torch.where(fg, torch.minimum(fwd, rev), sentinel)


def _min_neighbor_labels(lab: torch.Tensor, sentinel: int) -> torch.Tensor:
    """Min label over each pixel and its 8 neighbours (edges padded with
    the sentinel), on [B, H, W]."""
    b, h, w = lab.shape
    p = torch.full((b, h + 2, w + 2), sentinel, dtype=lab.dtype,
                   device=lab.device)
    p[:, 1:-1, 1:-1] = lab
    best = lab
    for dr in (-1, 0, 1):
        for dc in (-1, 0, 1):
            if dr or dc:
                best = torch.minimum(
                    best, p[:, 1 + dr:1 + dr + h, 1 + dc:1 + dc + w])
    return best


def label_components_plain(fg: torch.Tensor, return_sweeps: bool = False):
    """The plain version of ``label_components`` on [B, H, W] bool; with
    ``return_sweeps`` also the number of sweeps it ran (at most
    _MAX_SWEEPS, where it stops unconverged as the JAX package does)."""
    b, h, w = fg.shape
    sentinel = h * w
    idx = torch.arange(sentinel, dtype=torch.int32, device=fg.device)
    lab = torch.where(fg, idx.reshape(1, h, w), sentinel)
    active = torch.ones(b, dtype=torch.bool, device=fg.device)
    sweeps = 0
    while sweeps < _MAX_SWEEPS:
        sweeps += 1
        new = _seg_min_scan(lab, fg, 2, sentinel)  # row runs
        new = _seg_min_scan(new, fg, 1, sentinel)  # column runs
        new = torch.where(fg, _min_neighbor_labels(new, sentinel), sentinel)
        changed = (new != lab).flatten(1).any(dim=1)
        lab = torch.where(active[:, None, None], new, lab)
        active &= changed
        if not bool(active.any()):
            break
    return (lab, sweeps) if return_sweeps else lab


def component_areas_plain(fg: torch.Tensor,
                          labels: torch.Tensor | None = None
                          ) -> torch.Tensor:
    """The plain version of ``component_areas`` on [B, H, W] bool, from
    ``label_components_plain(fg)`` when given."""
    b, h, w = fg.shape
    lab = label_components_plain(fg) if labels is None else labels
    flat = lab.reshape(b, -1).long()
    counts = torch.zeros((b, h * w + 1), dtype=torch.int32, device=fg.device)
    counts.scatter_add_(1, flat, torch.ones_like(flat, dtype=torch.int32))
    area = counts.gather(1, flat).reshape(b, h, w)
    return torch.where(fg, area, 0)


def remove_small_zones_plain(img: torch.Tensor,
                             valid_h: torch.Tensor | None) -> torch.Tensor:
    """The plain version of ``remove_small_zones[_ragged]`` on [B, H, W]
    (``valid_h`` int [B], or None for every row)."""
    thr = SMALL_ZONE_THRESHOLD
    b, h, _ = img.shape
    if valid_h is None:
        vm = torch.ones((b, h, 1), dtype=torch.bool, device=img.device)
    else:
        vm = (torch.arange(h, device=img.device)[None, :]
              < valid_h.to(img.device)[:, None])[:, :, None]
    img_v = torch.where(vm, img, 0)
    inv = img_v != 0  # the holes step: complement of the class-0 mask
    filled = ~(inv & (component_areas_plain(inv) >= thr))
    objects = filled & vm
    cleaned = objects & (component_areas_plain(objects) >= thr)
    out = torch.where(~cleaned & (img_v == 0) & vm, 1, img_v)
    return torch.where(cleaned & (img_v != 0), 0, out)


# ---------------------------------------------------------------- kernels


def _batched(x: torch.Tensor, name: str) -> torch.Tensor:
    if x.dim() not in (2, 3):
        raise ValueError(f"{name}: expected [H, W] or [B, H, W], got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _ELEM_BYTES:
        raise TypeError(f"{name}: expected bool, uint8, int32 or int64, got "
                        f"{x.dtype}")
    if x.shape[-2] * x.shape[-1] + 1 >= 2 ** 31:
        raise ValueError(f"{name}: an image of {x.shape[-2]} x "
                         f"{x.shape[-1]} pixels exceeds int32 labels")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if x.device.type == "cuda" and not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous CUDA tensor (the "
                         f"kernels read it in place)")
    return x if x.dim() == 3 else x[None]


def _unbatched(out: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return out if like.dim() == 3 else out[0]


class _Launch:
    """The ccl library, the stream, the shape and the scratch of one
    wrapper call on a CUDA tensor [B, H, W]. A labelling leaves each
    foreground pixel's tile root in ``parent`` and the tile root's global
    root there too (two hops to the label), and each component's area at
    its global root in ``areas``."""

    def __init__(self, x: torch.Tensor) -> None:
        self.lib = kernel_lib("ccl")
        self.device = x.device
        self.b, self.h, self.w = x.shape
        with torch.cuda.device(x.device):
            self.stream = torch.cuda.current_stream(x.device).cuda_stream
        # each tile's roots, for each labelling
        self.scratch = self.empty(
            self.lib.ccl_scratch_ints(self.b, self.h, self.w))

    def empty(self, *shape: int, dtype=torch.int32) -> torch.Tensor:
        return torch.empty(shape, dtype=dtype, device=self.device)

    def plane(self) -> torch.Tensor:
        return self.empty(self.b, self.h, self.w)

    def run(self, entry: str, *args) -> None:
        with torch.cuda.device(self.device):
            rc = getattr(self.lib, entry)(*args, self.b, self.h, self.w,
                                          self.stream)
        check_launch(f"ccl ({entry})", rc)

    def label(self, src: torch.Tensor, invert: bool,
              valid_h: torch.Tensor | None, areas: torch.Tensor | None,
              write_labels: bool = False) -> torch.Tensor:
        """The labelling of fg = (row < valid_h) & ((src != 0) != invert);
        with ``write_labels`` the final labels."""
        parent = self.plane()
        self.run("ccl_label_launch", src.data_ptr(), _ELEM_BYTES[src.dtype],
                 int(invert), _ptr(valid_h), parent.data_ptr(), _ptr(areas),
                 self.scratch.data_ptr(), int(write_labels))
        return parent


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _labels_kernel(fg: torch.Tensor) -> torch.Tensor:
    lab = _Launch(fg).label(fg, False, None, None, write_labels=True)
    LAUNCHES.add()
    return lab


def _areas_kernel(fg: torch.Tensor) -> torch.Tensor:
    k = _Launch(fg)
    areas = k.plane()
    parent = k.label(fg, False, None, areas)
    out = k.plane()
    k.run("ccl_area_launch", parent.data_ptr(), areas.data_ptr(),
          out.data_ptr())
    LAUNCHES.add()
    return out


def _keep_kernel(mask: torch.Tensor, thr: int, invert: bool) -> torch.Tensor:
    """(fg & area(fg) >= thr) != invert, with fg = mask != invert."""
    k = _Launch(mask)
    areas = k.plane()
    parent = k.label(mask, invert, None, areas)
    out = k.empty(k.b, k.h, k.w, dtype=torch.bool)
    k.run("ccl_keep_launch", parent.data_ptr(), areas.data_ptr(), int(thr),
          int(invert), out.data_ptr())
    LAUNCHES.add()
    return out


def _zones_kernel(img: torch.Tensor, valid_h: torch.Tensor | None
                  ) -> torch.Tensor:
    k = _Launch(img)
    thr = SMALL_ZONE_THRESHOLD
    holes_areas = k.plane()
    holes = k.label(img, False, valid_h, holes_areas)  # non-zero components
    # the filled class-0 mask cut at valid_h, built in the tile load
    objects, objects_areas = k.plane(), k.plane()
    k.run("ccl_label_filled_launch", holes.data_ptr(),
          holes_areas.data_ptr(), _ptr(valid_h), thr, objects.data_ptr(),
          objects_areas.data_ptr(), k.scratch.data_ptr())
    out = torch.empty_like(img)
    k.run("ccl_writeback_launch", img.data_ptr(), _ELEM_BYTES[img.dtype],
          _ptr(valid_h), objects.data_ptr(), objects_areas.data_ptr(), thr,
          out.data_ptr())
    LAUNCHES.add()
    return out


# ---------------------------------------------------------------- public


def _mask(fg: torch.Tensor, name: str) -> torch.Tensor:
    fg = _batched(fg, name)
    return fg if fg.dtype == torch.bool else fg != 0


def label_components(fg: torch.Tensor) -> torch.Tensor:
    """8-connected component labels of a mask [H, W] / [B, H, W] (nonzero
    is foreground): int32, the per-image flat index of each component's
    smallest pixel, H * W on the background."""
    m = _mask(fg, "label_components")
    if m.device.type == "cpu":
        return _unbatched(label_components_plain(m), fg)
    return _unbatched(_labels_kernel(m), fg)


def component_areas(fg: torch.Tensor) -> torch.Tensor:
    """Per-pixel area of the component holding each foreground pixel, 0 on
    the background: int32, the mask's shape."""
    m = _mask(fg, "component_areas")
    if m.device.type == "cpu":
        return _unbatched(component_areas_plain(m), fg)
    return _unbatched(_areas_kernel(m), fg)


def remove_small_objects(mask: torch.Tensor,
                         min_size: int = SMALL_ZONE_THRESHOLD
                         ) -> torch.Tensor:
    """Drop 8-connected components with area < min_size (bool out)."""
    m = _mask(mask, "remove_small_objects")
    if m.device.type == "cpu":
        out = m & (component_areas_plain(m) >= min_size)
    else:
        out = _keep_kernel(m, min_size, False)
    return _unbatched(out, mask)


def remove_small_holes(mask: torch.Tensor,
                       area_threshold: int = SMALL_ZONE_THRESHOLD
                       ) -> torch.Tensor:
    """Fill complement components with area < area_threshold (bool out;
    no border exclusion)."""
    m = _mask(mask, "remove_small_holes")
    if m.device.type == "cpu":
        inv = ~m
        out = ~(inv & (component_areas_plain(inv) >= area_threshold))
    else:
        out = _keep_kernel(m, area_threshold, True)
    return _unbatched(out, mask)


def remove_small_zones(img: torch.Tensor) -> torch.Tensor:
    """Reference utils.py:135-148 on [H, W] or [B, H, W] class maps, each
    image labelled on its own; the input's dtype."""
    x = _batched(img, "remove_small_zones")
    if x.device.type == "cpu":
        return _unbatched(remove_small_zones_plain(x, None), img)
    return _unbatched(_zones_kernel(x, None), img)


def remove_small_zones_ragged(img: torch.Tensor, valid_h) -> torch.Tensor:
    """remove_small_zones on each image's first valid_h rows of a padded
    [H, W] (valid_h an int) or [B, H, W] (valid_h [B]) class map; padded
    rows come back 0."""
    x = _batched(img, "remove_small_zones_ragged")
    vh = torch.as_tensor(valid_h).reshape(-1)
    if vh.shape[0] != x.shape[0] or vh.dtype.is_floating_point \
            or vh.dtype == torch.bool:
        raise ValueError(f"remove_small_zones_ragged: valid_h must be "
                         f"{x.shape[0]} integer heights, got {vh.dtype} "
                         f"{tuple(vh.shape)}")
    vh = vh.to(device=x.device, dtype=torch.int32).contiguous()
    if x.device.type == "cpu":
        return _unbatched(remove_small_zones_plain(x, vh), img)
    return _unbatched(_zones_kernel(x, vh), img)
