"""The ranks of a job as a grid over the axes ``dp``, ``t`` and ``view``
(counterpart of ``parallel/mesh.py``; the reference's NCCL/accelerate DDP
stack, SURVEY.md §2.4, §5.8).

* ``dp``   — data parallel over the sample axis: each dp index takes its
             rows of the global batch.
* ``t``    — the video model's frame axis (SURVEY.md §5.7): the leading
             (clip, frame) axis is cut over (dp, t) together, each dp index
             taking its clips and each t index its contiguous frames of
             every one of them (``frame_rows``). The temporal attention
             regroups the frames over the ``t`` group (``exchange_frames``),
             the port's form of the all-to-alls XLA lowers JAX's
             frame-sharded ``_temporal`` to.
* ``view`` — the camera axis: each view index takes its contiguous block
             of a sample's cameras, and the cross-view attention gathers
             the others' normed hidden states over the ``view`` group
             (``gather_views``), the port's form of the JAX package's
             cross-device neighbour exchange (docs/sharding.md).

Training averages the trainable gradients over every rank of the grid (the
``all`` group): the ranks along ``t`` and ``view`` hold the same weights, as
those along ``dp`` do, and each one's gradient is its share of the loss's.

Ranks are laid out rank-major, as JAX's ``reshape(shape)`` lays out its
devices: on a (dp, view) grid rank r sits at (r // view, r % view).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .multihost import COLLECTIVES, initialized, process_count, process_index

AXES = ("dp", "t", "view")
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
    process group of the ranks that differ only along it, and under "all"
    the group of every rank of the grid (None where no process group is
    up)."""
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
    def t(self) -> int:
        return self.size("t")

    @property
    def view(self) -> int:
        return self.size("view")

    @property
    def ranks(self) -> int:
        return int(np.prod(self.shape))

    def dp_only(self) -> "Mesh":
        """The grid seen as its dp axis alone: the ranks along ``t`` and
        ``view`` become replicas that take the same rows and all cameras
        (the JAX runner's dp-only batch sharding, ``train/runner.py``), and
        the gradient mean runs over the dp group."""
        g = self.group("dp")
        return Mesh((self.dp,), ("dp",), (self.index("dp"),),
                    {} if g is None else {"dp": g, "all": g})


def coords_of(rank: int, shape: Sequence[int]) -> Tuple[int, ...]:
    """A rank's place on the rank-major grid."""
    return tuple(int(c) for c in np.unravel_index(rank, tuple(shape)))


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("dp", "view")) -> Mesh:
    """The job's ranks as a grid over ``axis_names`` (of AXES, each once);
    ``shape`` None puts every rank on the first axis. A grid needing more
    ranks than the job has raises, as JAX's assert does; one needing fewer
    raises too (a rank outside the grid would have no rows to take). With a
    process group up, every rank makes every axis's groups
    (``dist.new_group`` is collective)."""
    names = tuple(axis_names)
    if len(set(names)) != len(names) or not set(names) <= set(AXES):
        raise ValueError(f"mesh axes {names}: each of {AXES} at most once")
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
        groups["all"] = dist.group.WORLD
    return Mesh(shape, names, coords_of(rank, shape), groups)


def _block(n: int, parts: int, index: int, what: str) -> slice:
    if n % parts:
        raise ValueError(f"{what}: {parts} ranks do not divide {n}")
    m = n // parts
    return slice(index * m, (index + 1) * m)


def frame_rows(mesh: Mesh, n: int, frames: Optional[int] = None):
    """This rank's rows of a leading axis of n rows: the dp block
    [i n/dp, (i+1) n/dp); under a ``t`` axis > 1 the axis is (clip,
    frame) with ``frames`` frames a clip, and the rank takes frames
    [j F/t, (j+1) F/t) of each of its dp block's clips (an index array).
    That is JAX's ``P(("dp", "t"))`` on the leading axis
    (``tests/test_video_sharding.py`` ``_shard_over_frames``) where the
    clips equal dp; with more clips a rank, a contiguous cut would hand a
    t rank whole clips and the frame exchange nothing to regroup."""
    if mesh.t == 1:
        return _block(n, mesh.dp, mesh.index("dp"), f"{n} rows")
    if not frames:
        raise ValueError(f"a t axis of {mesh.t} ranks cuts the frames of a "
                         "clip: the model has no frame axis")
    if n % frames:
        raise ValueError(f"{n} rows are no whole number of {frames}-frame "
                         "clips")
    clips = _block(n // frames, mesh.dp, mesh.index("dp"),
                   f"{n // frames} clips")
    f = _block(frames, mesh.t, mesh.index("t"), f"{frames} frames")
    return (np.arange(clips.start, clips.stop)[:, None] * frames +
            np.arange(f.start, f.stop)[None, :]).reshape(-1)


def take_rows(v, rows):
    """v[rows] for a numpy array or a tensor, ``rows`` a slice or an index
    array."""
    if isinstance(rows, slice) or not torch.is_tensor(v):
        return v[rows]
    return v[torch.as_tensor(rows, device=v.device)]


def shard_batch(batch: Mapping[str, object], mesh: Mesh,
                n_cam: Optional[int] = None,
                frames: Optional[int] = None) -> Dict[str, object]:
    """This rank's block of a host batch (numpy arrays or tensors): its
    ``frame_rows`` of every sample-axis array (``frames`` a clip under a
    ``t`` axis); ``uncond_ids``, ``uncond_embeds`` and 0-d arrays whole.
    With ``n_cam`` and a ``view`` axis > 1, the camera-axis keys
    (CAMERA_KEYS) also take this rank's views [j n/view, (j+1) n/view) for
    view index j."""
    shard_views = n_cam is not None and mesh.view > 1
    out = {}
    for k, v in batch.items():
        if k in WHOLE_KEYS or np.ndim(v) == 0:
            out[k] = v
            continue
        try:
            v = take_rows(v, frame_rows(mesh, len(v), frames))
        except ValueError as e:
            raise ValueError(f"batch {k}: {e}") from None
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
# view-sharded pipeline or step runs (sharded_views), and the mesh whose t
# axis the temporal attention exchanges frames over (sharded_frames).
# Context variables, so a forward in another thread or task does not see
# another's mesh.
_VIEW_MESH: contextvars.ContextVar[Optional[Mesh]] = contextvars.ContextVar(
    "view_mesh", default=None)
_FRAME_MESH: contextvars.ContextVar[Optional[Mesh]] = \
    contextvars.ContextVar("frame_mesh", default=None)


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


@contextlib.contextmanager
def sharded_frames(mesh: Optional[Mesh]) -> Iterator[None]:
    """Inside the block, the temporal attention of this thread attends over
    the frames of ``mesh``'s t axis where it is larger than 1."""
    token = _FRAME_MESH.set(mesh if mesh is not None and mesh.t > 1
                            else None)
    try:
        yield
    finally:
        _FRAME_MESH.reset(token)


def view_mesh() -> Optional[Mesh]:
    """The mesh of the enclosing ``sharded_views``, None unsharded."""
    return _VIEW_MESH.get()


def frame_mesh() -> Optional[Mesh]:
    """The mesh of the enclosing ``sharded_frames``, None unsharded."""
    return _FRAME_MESH.get()


def local_views(mesh: Mesh, n: int) -> slice:
    """This rank's cameras of n."""
    return _block(n, mesh.view, mesh.index("view"), f"{n} cameras")


def _all_to_all(x: torch.Tensor, send: Sequence[int], recv: Sequence[int],
                group) -> torch.Tensor:
    """x (sum(send), ...) -> (sum(recv), ...): rows [sum(send[:k]),
    sum(send[:k+1])) go to rank k of ``group``, and recv[k] rows come from
    it, in rank order. The bytes travel as uint8, so any dtype crosses any
    backend unchanged; under gloo a CUDA tensor is staged through the host
    (gloo's all-to-all takes host tensors)."""
    x = x.contiguous()
    stage = x.is_cuda and dist.get_backend(group) == "gloo"
    src = (x.cpu() if stage else x).view(torch.uint8)
    out = src.new_empty((sum(recv), *src.shape[1:]))
    dist.all_to_all_single(out, src, list(recv), list(send), group=group)
    COLLECTIVES["all_to_all"] += 1
    out = out.view(x.dtype)
    return out.to(x.device) if stage else out


def _splits(rows: int, parts: int) -> List[int]:
    """rows cut into ``parts`` runs as even as they go, the longer first
    (no row dropped where parts does not divide rows)."""
    return [rows // parts + (k < rows % parts) for k in range(parts)]


def _to_frames(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """x (R, f/t, C), this rank's frames of R rows -> (R_j, f, C), every
    frame of this rank's run j of the rows (``_splits``), frames in order
    (t rank k holds frames [k f/t, (k+1) f/t))."""
    t, j = mesh.t, mesh.index("t")
    sizes = _splits(x.shape[0], t)
    y = _all_to_all(x, sizes, [sizes[j]] * t, mesh.group("t"))
    y = y.reshape(t, sizes[j], *x.shape[1:])
    return y.transpose(0, 1).reshape(sizes[j], t * x.shape[1], *x.shape[2:])


def _from_frames(y: torch.Tensor, mesh: Mesh, rows: int) -> torch.Tensor:
    """``_to_frames``'s inverse: y (R_j, f, C) -> (R, f/t, C), each rank's
    frames of every row sent back."""
    t, j = mesh.t, mesh.index("t")
    sizes = _splits(rows, t)
    f = y.shape[1] // t
    x = y.reshape(sizes[j], t, f, *y.shape[2:]).transpose(0, 1)
    return _all_to_all(x.reshape(t * sizes[j], f, *y.shape[2:]),
                       [sizes[j]] * t, sizes, mesh.group("t"))


class _FrameExchange(torch.autograd.Function):
    """``_to_frames`` (``inverse`` False) or ``_from_frames`` (True), with
    the other as its backward: a permutation of rows across ranks, so its
    adjoint is its inverse."""

    @staticmethod
    def forward(ctx, x, mesh, inverse, rows):
        ctx.mesh, ctx.inverse, ctx.rows = mesh, inverse, x.shape[0]
        return _from_frames(x, mesh, rows) if inverse else \
            _to_frames(x, mesh)

    @staticmethod
    def backward(ctx, g):
        g = _to_frames(g, ctx.mesh) if ctx.inverse else \
            _from_frames(g, ctx.mesh, ctx.rows)
        return g, None, None, None


def exchange_frames(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """x (R, f/t, C), the R rows (b n L) of this rank's f/t frames ->
    (R_j, f, C): every frame of this rank's run of the rows, over the t
    group (one all-to-all; R cut as evenly as it goes, so an R that t does
    not divide loses no row). ``return_frames`` sends the rows back."""
    return _FrameExchange.apply(x, mesh, False, 0)


def return_frames(y: torch.Tensor, mesh: Mesh, rows: int) -> torch.Tensor:
    """``exchange_frames``'s inverse: (R_j, f, C) -> (R, f/t, C) of
    ``rows`` R."""
    return _FrameExchange.apply(y, mesh, True, rows)


def _all_gather(x: torch.Tensor, mesh: Mesh, m: int) -> torch.Tensor:
    """x (B*m, ...) -> (B*m*view, ...), every camera of each sample in
    camera order, gathered over the view group as uint8 bytes."""
    x = x.contiguous()
    parts = [torch.empty_like(x.view(torch.uint8))
             for _ in range(mesh.view)]
    dist.all_gather(parts, x.view(torch.uint8), group=mesh.group("view"))
    COLLECTIVES["all_gather"] += 1
    rest = x.shape[1:]
    views = [p.view(x.dtype).reshape(-1, m, *rest) for p in parts]
    return torch.cat(views, dim=1).reshape(-1, *rest)


def _scatter_sum(g: torch.Tensor, mesh: Mesh, m: int) -> torch.Tensor:
    """``_all_gather``'s adjoint: g (B*m*view, ...), the gradient of every
    camera on this rank -> (B*m, ...), the sum over the view group of the
    gradients of this rank's cameras: one all-to-all that sends each rank
    its cameras' rows, summed in fp32 in rank order, in g's dtype."""
    v, rest = mesh.view, g.shape[1:]
    parts = g.float().reshape(-1, v, m, *rest).transpose(0, 1)
    rows = parts.shape[1] * m
    got = _all_to_all(parts.reshape(v * rows, *rest), [rows] * v,
                      [rows] * v, mesh.group("view"))
    return got.reshape(v, rows, *rest).sum(0).to(g.dtype)


class _GatherViews(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, m):
        ctx.mesh, ctx.m = mesh, m
        return _all_gather(x, mesh, m)

    @staticmethod
    def backward(ctx, g):
        return _scatter_sum(g, ctx.mesh, ctx.m), None, None


def gather_views(x: torch.Tensor, mesh: Mesh, m: int) -> torch.Tensor:
    """x (B*m, ...), this rank's m cameras of each sample (views
    innermost) -> (B*m*view, ...), every camera of each sample in camera
    order, gathered over the view group. The bytes travel as uint8, so any
    dtype crosses any backend unchanged. Its backward sends each camera's
    gradient to the rank that owns it and sums them there
    (``_scatter_sum``)."""
    return _GatherViews.apply(x, mesh, m)
