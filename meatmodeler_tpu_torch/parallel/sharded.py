"""Multi-device execution over a mesh of devices in one process (torch twin
of ``meatmodeler_tpu/parallel/sharded.py``).

The reference drives a ``jax.sharding.Mesh`` through ``shard_map`` from one
process. This module keeps that shape: a :class:`Mesh` is a small
(data, model) grid of ``torch.device``s, and one host thread steps the work
of every member in turn; CUDA runs each device's queue on its own, so the
members overlap. Its parts:

  * **data-parallel BA** (``solve_ba_batch``): a batch of independent
    problems split over ``data``, no communication;
  * **point-sharded BA** (``solve_ba_point_sharded``): ONE problem with its
    points split over ``data``; the camera-sized sums are all-reduced, the
    point blocks stay on their device;
  * **tensor-parallel matching** (``match_descriptors_tp``): the train
    descriptors split over ``model``, each member's top-2 candidates
    all-gathered and reduced to the global top-2;
  * **sharded preprocessing** (``preprocess_sharded``): CLAHE + grey of a
    frame batch split over ``data``.

The collectives (``all_reduce_sum``, ``all_gather``) take one tensor per
mesh member. Between distinct GPUs they go through NCCL's single-process
binding (``torch.cuda.nccl``, the one ``torch.nn.parallel`` uses); on a
mesh that repeats one device (virtual shards: ``devices=["cpu"] * n`` in
the tests, or ``["cuda:0"] * n``) they are an ordered sum or a stack on that
device. Any other mix of devices is refused, and nothing falls back from
NCCL to copies.

One host thread steps every shard in lockstep. On the card the Jacobians
are a kernel (``solvers/bundle_adjust_cuda``) and take no lock; on the CPU
their plain version's forward-mode AD takes a process-wide one
(``utils.numerics.one_thread_at_a_time``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from meatmodeler_tpu_torch.config import SolverConfig
from meatmodeler_tpu_torch.ops import clahe
from meatmodeler_tpu_torch.ops.matching import hamming_matrix
from meatmodeler_tpu_torch.solvers import bundle_adjust

__all__ = [
    "Mesh",
    "make_mesh",
    "all_reduce_sum",
    "all_gather",
    "preprocess_sharded",
    "solve_ba_batch",
    "solve_ba_point_sharded",
    "match_descriptors_tp",
]

_BIG = 1e9


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (data, model) grid of devices: ``devices[i][j]`` is the member at
    data index i and model index j; ``shape["data"]``, ``shape["model"]``
    as in ``jax.sharding.Mesh``."""

    devices: Tuple[Tuple[torch.device, ...], ...]

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": len(self.devices), "model": len(self.devices[0])}

    def data_devices(self) -> List[torch.device]:
        """The members along ``data`` (model index 0; the other model
        members hold replicas)."""
        return [row[0] for row in self.devices]


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(data: Optional[int] = None, model: int = 1, devices=None) -> Mesh:
    """Build a (data, model) mesh over ``devices`` (default: every visible
    GPU; without CUDA this raises). A list that repeats one device, such as
    ``["cpu"] * 8``, gives virtual shards on it."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: CUDA is not available; pass devices= (e.g. ['cpu'] * n) for virtual shards")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [_device(d) for d in devices]
    n = len(devices)
    if data is None:
        data = n // model
    assert data * model <= n, (data, model, n)
    return Mesh(tuple(tuple(devices[i * model : (i + 1) * model]) for i in range(data)))


def _one_device(tensors: Sequence[torch.Tensor]) -> bool:
    """True for tensors all on one device, False for tensors on distinct
    GPUs (the NCCL case); raises for anything else."""
    devices = [t.device for t in tensors]
    distinct = len(set(devices))
    if distinct == 1:
        return True
    if distinct == len(devices) and all(d.type == "cuda" for d in devices):
        return False
    raise ValueError(
        f"a collective needs one device repeated or distinct GPUs, got {[str(d) for d in devices]}"
    )


def _nccl(tensors):
    from torch.cuda import nccl

    if not nccl.is_available(tensors):
        raise RuntimeError("torch.cuda.nccl cannot run these tensors (torch built without NCCL?)")
    return nccl


def all_reduce_sum(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """One tensor per mesh member in; their elementwise sum out, one per
    member on its device (the reference's ``psum``). The inputs are not
    modified."""
    if _one_device(tensors):
        total = tensors[0]
        for t in tensors[1:]:
            total = total + t
        return [total] * len(tensors)
    out = [t.clone(memory_format=torch.contiguous_format) for t in tensors]
    _nccl(out).all_reduce(out)
    return out


def all_gather(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """One tensor per mesh member in; their (members, ...) stack out, one
    per member on its device (the reference's ``all_gather``)."""
    if _one_device(tensors):
        return [torch.stack(list(tensors))] * len(tensors)
    inputs = [t.contiguous() for t in tensors]
    out = [t.new_empty((len(tensors),) + tuple(t.shape)) for t in inputs]
    _nccl(inputs).all_gather(inputs, out)
    return out


def preprocess_sharded(mesh: Mesh, frames) -> torch.Tensor:
    """CLAHE + grey (``clahe.enhanced_grey``) over a (B, H, W, 3) uint8 frame
    batch split over ``data`` (B must divide by its size): each chunk runs
    on its own device, which launches the CLAHE kernels there on the card,
    and the (B, H, W) float32 result is gathered to the first device."""
    frames = torch.as_tensor(frames)
    devices = mesh.data_devices()
    if frames.shape[0] % len(devices):
        raise ValueError(f"{frames.shape[0]} frames do not split over a data axis of {len(devices)}")
    outs = [clahe.enhanced_grey(c.to(dev)) for c, dev in zip(frames.chunk(len(devices)), devices)]
    return torch.cat([o.to(devices[0]) for o in outs])


def solve_ba_batch(
    mesh: Mesh, problems: bundle_adjust.BAProblem, config: Optional[SolverConfig] = None
) -> bundle_adjust.BAResult:
    """Independent BA solves split over ``data``: ``problems`` carries a
    leading lane axis on every field (``bundle_adjust.solve_ba_batch``'s
    layout) whose length divides the data axis. Each device runs its lanes'
    batched LM (``bundle_adjust._BatchSolve``), with per-lane damping and
    stopping; the one LM loop (``bundle_adjust._lm_loop``) steps the devices
    in lockstep and fetches every device's "any lane active" flag in one
    read an iteration (a device whose lanes are done stops stepping). No
    communication. The results come back in lane order on the problems'
    device."""
    config = config or SolverConfig()
    devices = mesh.data_devices()
    nv = problems.cam_params.shape[0]
    if nv % len(devices):
        raise ValueError(f"a batch of {nv} problems does not split over a data axis of {len(devices)}")
    per = nv // len(devices)
    solves = [
        bundle_adjust._BatchSolve(
            [bundle_adjust.BAProblem(*(None if x is None else x[i * per : (i + 1) * per].to(dev) for x in problems))],
            config,
        )
        for i, dev in enumerate(devices)
    ]
    bundle_adjust._lm_loop(solves)
    home = problems.cam_params.device
    results = [s.result() for s in solves]
    return bundle_adjust.BAResult(*(torch.cat([f.to(home) for f in fields]) for fields in zip(*results)))


def solve_ba_point_sharded(
    mesh: Mesh, problem: bundle_adjust.BAProblem, config: Optional[SolverConfig] = None, init_lambda=None
) -> bundle_adjust.BAResult:
    """ONE bundle-adjustment problem with its points split over ``data``.

    Host prep as the reference's: the points fall into ``data`` contiguous
    blocks of ceil(P / data) (the last padded with unobserved points), each
    valid observation goes to its point's block with a local point index,
    and every shard's observation list is padded (masked) to the longest.
    One lane of the LM (``bundle_adjust._BatchSolve``) then steps every
    shard on its device: the camera-sized sums (U, b_c, the Schur cross term, the
    reduced RHS, the costs, the observation count, the rmse's sum) go
    through :func:`all_reduce_sum`, so every shard walks the same
    trajectory; the point blocks, and the (P / data, F, 6, 3) Schur strips,
    stay on their device. Returns a BAResult like ``solve_ba`` on the whole
    problem, points in the original order, on the problem's device."""
    config = config or SolverConfig()
    devices = mesh.data_devices()
    d = len(devices)
    home = problem.points.device
    pidx, fidx = problem.point_idx.long(), problem.frame_idx.long()
    valid = problem.mask.bool()
    weight = torch.ones_like(problem.obs[:, 0]) if problem.weight is None else problem.weight
    p_total = problem.points.shape[0]
    pl = -(-p_total // d)  # points per shard, padded
    pts = torch.cat([problem.points, problem.points.new_zeros((d * pl - p_total, 3))]).reshape(d, pl, 3)
    shard_of_obs = torch.clamp(pidx // pl, max=d - 1)
    local_pidx = pidx - shard_of_obs * pl
    counts = torch.bincount(shard_of_obs[valid], minlength=d).tolist()
    nl = max(max(counts), 1)

    shards = []
    for s, dev in enumerate(devices):
        sel = valid & (shard_of_obs == s)

        def padded(x, fill=0):
            out = x.new_full((nl,) + tuple(x.shape[1:]), fill)
            out[: counts[s]] = x[sel]
            return out.to(dev)

        shards.append(bundle_adjust.BAProblem(
            cam_params=problem.cam_params.to(dev),
            points=pts[s].to(dev),
            intrinsics=problem.intrinsics.to(dev),
            obs=padded(problem.obs),
            frame_idx=padded(fidx),
            point_idx=padded(local_pidx),
            mask=torch.arange(nl, device=dev) < counts[s],
            weight=padded(weight, 1),
        ))
    res = bundle_adjust._solve_one(shards, config, init_lambda=init_lambda, reduce=all_reduce_sum)
    return res._replace(
        cam_params=res.cam_params.to(home),
        points=res.points[:p_total].to(home),
        cost=res.cost.to(home),
        rmse=res.rmse.to(home),
        final_lambda=res.final_lambda.to(home),
    )


def match_descriptors_tp(
    mesh: Mesh,
    query: torch.Tensor,
    train: torch.Tensor,
    query_mask: torch.Tensor,
    train_mask: torch.Tensor,
    ratio: float = 0.75,
    max_distance: float = 256.0,
):
    """Tensor-parallel knn(2) Hamming matching over ``model``: each member
    holds a (Q, T / model) slab of the distance matrix and reduces it to
    per-row top-2 candidates, which one :func:`all_gather` brings together;
    the global top-2 is reduced from them with the reference's slot order
    (ties to the lower member, then the lower train index). T must divide by
    the model axis. Returns (best_train_idx, best_dist, good_mask) per query
    row, on the first member's device."""
    devices = list(mesh.devices[0])
    m = len(devices)
    t = train.shape[0]
    if t % m:
        raise ValueError(f"{t} train descriptors do not split over a model axis of {m}")
    ts = t // m
    cand_d, cand_i = [], []
    for j, dev in enumerate(devices):
        big = torch.tensor(_BIG, dtype=torch.float32, device=dev)
        dist = hamming_matrix(query.to(dev), train[j * ts : (j + 1) * ts].to(dev))
        dist = torch.where(train_mask[j * ts : (j + 1) * ts].to(dev)[None, :], dist, big)
        dist = torch.where(query_mask.to(dev)[:, None], dist, big)
        local_best = torch.argmin(dist, dim=1)  # first minimum, like jnp.argmin
        local_best_d = torch.gather(dist, 1, local_best[:, None])[:, 0]
        iota = torch.arange(ts, device=dev)
        local_second_d = torch.amin(torch.where(iota == local_best[:, None], big, dist), dim=1)
        cand_d.append(torch.stack([local_best_d, local_second_d], dim=1))
        cand_i.append(local_best + j * ts)
    gathered_d = all_gather(cand_d)[0]  # (m, Q, 2)
    gathered_i = all_gather(cand_i)[0]  # (m, Q)

    q_n = query.shape[0]
    dev = devices[0]
    big = torch.tensor(_BIG, dtype=torch.float32, device=dev)
    flat_d = gathered_d.transpose(0, 1).reshape(q_n, 2 * m)  # slots: member 0 best, second, member 1 ...
    best_slot = torch.argmin(flat_d, dim=1)
    best_d = torch.gather(flat_d, 1, best_slot[:, None])[:, 0]
    slots = torch.arange(2 * m, device=dev)
    second_d = torch.amin(torch.where(slots == best_slot[:, None], big, flat_d), dim=1)
    # The global best always comes from some member's local best slot.
    best_idx = torch.gather(gathered_i.T, 1, (best_slot // 2)[:, None])[:, 0]
    good = (best_d < ratio * second_d) & (best_d <= max_distance) & query_mask.to(dev)
    return best_idx, best_d, good
