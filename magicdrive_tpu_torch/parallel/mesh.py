"""The ranks of a job as a (dp, view) grid (counterpart of
``parallel/mesh.py``; the reference's NCCL/accelerate DDP stack, SURVEY.md
§2.4, §5.8).

* ``dp``   — data parallel over the sample axis: each dp index takes its
             rows of the global batch; training averages the trainable
             gradients over the ``dp`` group.
* ``view`` — the camera axis, for sampling: each view index takes its
             contiguous block of a sample's cameras, and the cross-view
             attention gathers the others' normed hidden states over the
             ``view`` group (``gather_views``), the port's form of the JAX
             package's cross-device neighbour exchange (docs/sharding.md).

Ranks are laid out rank-major, as JAX's ``reshape(shape)`` lays out its
devices: rank r sits at (r // view, r % view).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Dict, Iterator, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .multihost import COLLECTIVES, initialized, process_count, process_index

# The batch keys whose axis 1 is the camera axis. Only these are
# view-sharded: the JAX package's rule (any axis 1 of size n_cam,
# parallel/mesh.py:67) would also shard a key whose axis 1 merely has that
# size. The box keys are per view in their per-view layout alone (BOX_NDIM);
# view-shared boxes (axis 1 of size 1) stay whole.
CAMERA_KEYS = ("camera_param", "latents", "pixel_values", "bboxes",
               "classes", "masks")
BOX_NDIM = {"bboxes": 5, "classes": 3, "masks": 3}
# keys without a sample axis, kept whole on every rank
WHOLE_KEYS = ("uncond_ids", "uncond_embeds")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The grid's ``shape``, this rank's ``coords`` on it, and per axis the
    process group of the ranks that differ only along it (None where no
    process group is up)."""
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...] = ("dp", "view")
    coords: Tuple[int, ...] = (0, 0)
    groups: Mapping[str, Optional[dist.ProcessGroup]] = dataclasses.field(
        default_factory=dict)

    def size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)] \
            if axis in self.axis_names else 1

    def index(self, axis: str) -> int:
        return self.coords[self.axis_names.index(axis)] \
            if axis in self.axis_names else 0

    def group(self, axis: str) -> Optional[dist.ProcessGroup]:
        return self.groups.get(axis)

    @property
    def dp(self) -> int:
        return self.size("dp")

    @property
    def view(self) -> int:
        return self.size("view")


def coords_of(rank: int, shape: Sequence[int]) -> Tuple[int, ...]:
    """A rank's place on the rank-major grid."""
    return tuple(int(c) for c in np.unravel_index(rank, tuple(shape)))


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("dp", "view")) -> Mesh:
    """The job's ranks as a grid; ``shape`` None puts every rank on the
    first axis (``dp``). A grid needing more ranks than the job has raises,
    as JAX's assert does; one needing fewer raises too (a rank outside the
    grid would have no rows to take). With a process group up, every rank
    makes every axis's groups (``dist.new_group`` is collective)."""
    names = tuple(axis_names)
    world, rank = process_count(), process_index()
    shape = tuple(int(s) for s in shape) if shape else \
        (world,) + (1,) * (len(names) - 1)
    if len(shape) != len(names):
        raise ValueError(f"mesh shape {shape} for axes {names}")
    need = int(np.prod(shape))
    if need != world:
        raise ValueError(f"mesh {shape} needs {need} ranks, the job has "
                         f"{world}")
    groups: Dict[str, Optional[dist.ProcessGroup]] = {}
    if initialized():
        grid = np.arange(world).reshape(shape)
        for a, name in enumerate(names):
            lines = np.moveaxis(grid, a, -1).reshape(-1, shape[a])
            for line in lines:  # the same calls, in order, on every rank
                g = dist.new_group([int(r) for r in line])
                if rank in line:
                    groups[name] = g
    return Mesh(shape, names, coords_of(rank, shape), groups)


def _block(n: int, parts: int, index: int, what: str) -> slice:
    if n % parts:
        raise ValueError(f"{what}: {parts} ranks do not divide {n}")
    m = n // parts
    return slice(index * m, (index + 1) * m)


def shard_batch(batch: Mapping[str, object], mesh: Mesh,
                n_cam: Optional[int] = None) -> Dict[str, object]:
    """This rank's block of a host batch (numpy arrays or tensors): rows
    [i B/dp, (i+1) B/dp) of every sample-axis array for dp index i;
    ``uncond_ids``, ``uncond_embeds`` and 0-d arrays whole. With ``n_cam``
    and a ``view`` axis > 1, the camera-axis keys (CAMERA_KEYS) also take
    this rank's views [j n/view, (j+1) n/view) for view index j."""
    shard_views = n_cam is not None and mesh.view > 1
    out = {}
    for k, v in batch.items():
        if k in WHOLE_KEYS or np.ndim(v) == 0:
            out[k] = v
            continue
        v = v[_block(len(v), mesh.dp, mesh.index("dp"), f"batch {k}")]
        # the box keys in another layout than the per-view one stay whole
        if shard_views and v.ndim == BOX_NDIM.get(k, v.ndim) and \
                k in CAMERA_KEYS:
            n = v.shape[1]
            if n == n_cam:
                v = v[:, _block(n, mesh.view, mesh.index("view"),
                                f"{k}'s {n} cameras")]
            elif not (k in BOX_NDIM and n == 1):
                raise ValueError(f"{k} {tuple(v.shape)}: axis 1 is neither "
                                 f"the {n_cam} cameras nor view-shared")
        out[k] = v
    return out


# The mesh whose view axis the cross-view attention gathers over, while a
# view-sharded pipeline runs (sharded_views). A context variable, so a
# forward in another thread or task does not see another's mesh.
_VIEW_MESH: contextvars.ContextVar[Optional[Mesh]] = contextvars.ContextVar(
    "view_mesh", default=None)


@contextlib.contextmanager
def sharded_views(mesh: Optional[Mesh]) -> Iterator[None]:
    """Inside the block, the cross-view attention of this thread reads its
    neighbours across ``mesh``'s view axis where it is larger than 1."""
    token = _VIEW_MESH.set(mesh if mesh is not None and mesh.view > 1
                           else None)
    try:
        yield
    finally:
        _VIEW_MESH.reset(token)


def view_mesh() -> Optional[Mesh]:
    """The mesh of the enclosing ``sharded_views``, None unsharded."""
    return _VIEW_MESH.get()


def local_views(mesh: Mesh, n: int) -> slice:
    """This rank's cameras of n."""
    return _block(n, mesh.view, mesh.index("view"), f"{n} cameras")


def gather_views(x: torch.Tensor, mesh: Mesh, m: int) -> torch.Tensor:
    """x (B*m, ...), this rank's m cameras of each sample (views
    innermost) -> (B*m*view, ...), every camera of each sample in camera
    order, gathered over the view group. The bytes travel as uint8, so any
    dtype crosses any backend unchanged."""
    x = x.contiguous()
    parts = [torch.empty_like(x.view(torch.uint8))
             for _ in range(mesh.view)]
    dist.all_gather(parts, x.view(torch.uint8), group=mesh.group("view"))
    COLLECTIVES["all_gather"] += 1
    rest = x.shape[1:]
    views = [p.view(x.dtype).reshape(-1, m, *rest) for p in parts]
    return torch.cat(views, dim=1).reshape(-1, *rest)
