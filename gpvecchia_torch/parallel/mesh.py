"""Sharding over processes (``torch.distributed``) for scale-out.

The port of the JAX package's ``parallel/mesh.py``, where GSPMD shards the
row dimension of every batched kernel over a device mesh and inserts the
collectives.  Here each rank is a process with its own device, the caller
initializes the default process group (``torch.distributed``, any backend:
NCCL across cards, gloo on the CPU or for ranks that share one card), and
the exchanges are written out:

* ``make_mesh`` arranges the ranks as a (chains, rows) ``DeviceMesh``.
* A rank's share (``shard_rows``): on a multifrontal plan the tree splits
  by subtrees.  At every depth d >= log2 R (R the ranks along "rows") rank
  r owns the node range [r N/R, (r+1) N/R), a whole set of subtrees, since
  the children of node i are 2i and 2i+1; the log2 R levels above are
  replicated.  Every element (one per ordered point) lies in exactly one
  leaf, so rank r computes the U entries of its leaves' elements and only
  theirs (H1 on about n/R rows), their numerator terms and its subtrees'
  fronts (H2-H4).  On every other plan (the per-entry V engine) rank r owns
  a contiguous range of rows for the U entries, and the V engine runs
  replicated, as in the JAX package.  R must be a power of two on a
  multifrontal plan (``multifrontal.mf_device_arrays``), any R otherwise.
* The JAX package pads the row count to a multiple of the device count
  (``_pad_rows``).  Shares here are leaf sets or row ranges of any size, so
  nothing is padded and nothing of ``_pad_rows`` is ported.
* The factor's one exchange: after the own levels, every rank gets the
  whole set of the shallowest sharded depth's Schur blocks; then every rank
  runs the replicated top levels with the same kernels.

The exchanges use ``all_reduce`` alone (``RowShare.all_sum``), which NCCL
and gloo both take, on CUDA tensors too: an exact all-gather is an
``all_reduce`` SUM of a zero-filled buffer into which each rank wrote its
own slice (x + 0 = x).

The gradient counts each term once through one conjugate pair of autograd
Functions (``RowShare.replicate`` / ``reduce``, and ``all_gather``):

* the local part (a rank's own rows and subtrees) reads the replicated
  inputs through ``replicate``: forward the identity, backward a sum over
  the ranks;
* its scalars leave through ``reduce``: forward a sum over the ranks,
  backward the identity;
* the replicated part (the top levels, the V engine, the observation
  terms) reads the replicated inputs directly and the local results through
  ``all_gather``, the exact all-gather, whose backward keeps the rank's own
  slice and does not sum.

So ``torch.autograd.grad(value, covparms)`` on every rank returns the whole
gradient.  Every sum over the ranks gathers the ranks' terms and adds them
in rank order, so a run at a fixed R is reproducible bit for bit and every
rank holds the same bits.

``run_local`` spawns the ranks of a run on one machine (the port's
counterpart of the JAX tests' virtual CPU devices); ``torchrun
--nproc-per-node=<cards>`` with NCCL serves a machine with several cards.
"""

from __future__ import annotations

import os
import queue as _queue
import shutil
import tempfile
import time
import traceback
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
from torch.autograd.function import once_differentiable

from ..utils import trace

__all__ = ["make_mesh", "shard_rows", "sharded_loglik_core",
           "sharded_loglik_fn", "sharded_posterior_core", "run_local",
           "RowShare", "row_share", "mesh_device"]


def make_mesh(rows=None, chains=1, device_type="cuda"):
    """A (chains, rows) ``DeviceMesh`` over the default process group,
    which the caller has initialized (``run_local``, ``torchrun``): the
    ranks of one "rows" group share a likelihood, the "chains" groups run
    independent evaluations.  ``rows`` defaults to world / chains."""
    if not dist.is_available() or not dist.is_initialized():
        raise ValueError("make_mesh: no process group; initialize "
                         "torch.distributed first (run_local, torchrun)")
    world = dist.get_world_size()
    if rows is None:
        rows = world // max(chains, 1)
    if rows < 1 or chains < 1 or rows * chains != world:
        raise ValueError(
            f"make_mesh: {world} process(es) cannot form a (chains={chains}, "
            f"rows={rows}) mesh; start chains * rows processes (run_local, "
            f"torchrun --nproc-per-node)")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, (chains, rows),
                            mesh_dim_names=("chains", "rows"))


def mesh_device(mesh):
    """This rank's device on ``mesh``: the current CUDA device (each rank's
    own card, or cuda:0 for ranks that share one), or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


# ------------------------------------------------------------ exchanges ----

class RowShare:
    """A rank's place among ``size`` ranks of ``group`` and the exchanges
    between them.  With size 1 (``LOCAL``) every exchange is the identity
    and nothing is communicated."""

    def __init__(self, group=None, size=1, rank=0, device=None):
        self.group, self.size, self.rank = group, size, rank
        self.device = device         # where the exchanges' buffers live

    def all_sum(self, buf):
        """``buf`` summed over the ranks, in place."""
        if self.size == 1:
            return buf
        trace.count("mesh.exchange.calls")
        trace.count("mesh.exchange.bytes", buf.numel() * buf.element_size())
        dist.all_reduce(buf, group=self.group)
        return buf

    def gather_rows(self, t, offset, total):
        """The exact all-gather: (total, ...) with every rank's ``t`` at its
        ``offset``, and zeros where no rank wrote."""
        buf = t.new_zeros((total,) + tuple(t.shape[1:]))
        buf[offset:offset + t.shape[0]] = t
        return self.all_sum(buf)

    def sum_ranks(self, t):
        """The ranks' ``t`` added in rank order (every rank the same bits)."""
        if self.size == 1:
            return t
        buf = self.gather_rows(t.reshape(1, -1), self.rank, self.size)
        return torch.sum(buf, dim=0).reshape(t.shape)

    def replicate(self, *ts):
        """The replicated inputs as the local part reads them."""
        if self.size == 1:
            return ts
        return _Replicate.apply(self, *ts)

    def reduce(self, *scalars):
        """The local part's scalars summed over the ranks."""
        if self.size == 1:
            return scalars
        return _Reduce.apply(self, *scalars)

    def all_gather(self, t, offset=None, total=None):
        """The local tensors ``t`` of every rank along dim 0 (at ``offset``
        in ``total`` rows; by default equal slices in rank order)."""
        if self.size == 1:
            return t
        if offset is None:
            offset, total = self.rank * t.shape[0], self.size * t.shape[0]
        return _Gather.apply(self, t, offset, total)


LOCAL = RowShare()


def row_share(mesh):
    """The ``RowShare`` of this rank along ``mesh``'s "rows" dimension."""
    if mesh is None or mesh["rows"].size() == 1:
        return LOCAL
    return RowShare(mesh.get_group("rows"), mesh["rows"].size(),
                    mesh.get_local_rank("rows"), mesh_device(mesh))


class _Replicate(torch.autograd.Function):
    """Forward the identity; backward the cotangents summed over the
    ranks (in rank order)."""

    @staticmethod
    def forward(ctx, share, *ts):
        ctx.share = share
        ctx.meta = [(t.shape, t.dtype, t.device) for t in ts]
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    @once_differentiable
    def backward(ctx, *gs):
        need = ctx.needs_input_grad[1:]
        parts = [g for g, n in zip(gs, need) if n]
        # one buffer on the share's device (covparms may lie on the host)
        flat = ctx.share.sum_ranks(torch.cat([
            g.reshape(-1).to(ctx.share.device, parts[0].dtype)
            for g in parts]))
        out, pos = [], 0
        for (shape, dt, device), n in zip(ctx.meta, need):
            if not n:
                out.append(None)
                continue
            k = int(np.prod(shape, dtype=np.int64))
            out.append(flat[pos:pos + k].reshape(shape).to(device, dt))
            pos += k
        return (None, *out)


class _Reduce(torch.autograd.Function):
    """Forward the scalars summed over the ranks (in rank order);
    backward the identity."""

    @staticmethod
    def forward(ctx, share, *scalars):
        return share.sum_ranks(torch.stack(scalars)).unbind()

    @staticmethod
    def backward(ctx, *gs):
        return (None, *gs)


class _Gather(torch.autograd.Function):
    """Forward the exact all-gather along dim 0; backward this rank's own
    slice of the cotangent (no sum: every rank's replicated part computed
    the same cotangent)."""

    @staticmethod
    def forward(ctx, share, t, offset, total):
        ctx.sl = slice(offset, offset + t.shape[0])
        return share.gather_rows(t, offset, total)

    @staticmethod
    def backward(ctx, g):
        return None, g[ctx.sl], None, None


# ------------------------------------------------------ sharded cores ----

def _mesh_place(mesh, device):
    from ..inference.likelihood import resolve_device
    mesh = make_mesh() if mesh is None else mesh
    return mesh, (mesh_device(mesh) if device is None
                  else resolve_device(device))


def shard_rows(mesh, plan, dev=None, *, device=None, dtype=torch.float64):
    """This rank's share of the plan's device arrays along ``mesh``'s
    "rows" dimension (``likelihood._device_arrays``, cached in the plan
    under the device, the dtype and (R, r)): the row arrays of its own rows
    and its share of the multifrontal tree (own subtrees, replicated top
    levels); locations, observation arrays and the V engine's schedules
    replicated.  ``dev`` (the whole plan's arrays), when given, sets the
    device and dtype."""
    from ..inference.likelihood import _device_arrays
    if dev is not None:
        device, dtype = dev["locs"].device, dev["locs"].dtype
    device = mesh_device(mesh) if device is None else torch.device(device)
    return _device_arrays(plan, device, dtype, mesh["rows"].size(),
                          mesh.get_local_rank("rows"))


def _as_tensor(a, device, dtype):
    if not torch.is_tensor(a):
        a = torch.as_tensor(np.asarray(a, np.float64))
    return a.to(device, dtype)


def sharded_loglik_core(spec, covmodel="matern", mesh=None, dtype=None, *,
                        device=None):
    """(core, sharded_dev): ``core(dev, z, covparms, nuggets)`` is the
    log-likelihood with this rank's share ``sharded_dev`` (``shard_rows``),
    the whole value on every rank of the "rows" group, differentiable in
    covparms and nuggets (every rank gets the whole gradient).  Every rank
    of the group calls it with the same arguments.  ``mesh`` defaults to
    ``make_mesh()`` over the world, the device to the rank's
    (``mesh_device``), the dtype to float64."""
    from ..inference.likelihood import (_dispatch_covmodel, _loglik_core,
                                        _prepare_pack)
    from ..plan import get_plan
    dtype = torch.float64 if dtype is None else dtype
    mesh, device = _mesh_place(mesh, device)
    plan = get_plan(spec)
    cov = _dispatch_covmodel(spec, covmodel, device, dtype)
    sharded = shard_rows(mesh, plan, device=device, dtype=dtype)
    share = row_share(mesh)

    def core(dev, z, covparms, nuggets):
        pack = _prepare_pack(dev, _as_tensor(z, device, dtype))
        return _loglik_core(plan, dev, pack, covparms, nuggets, dtype,
                            device, cov, share)[0]

    return core, sharded


def sharded_loglik_fn(spec, covmodel="matern", mesh=None, dtype=None, *,
                      device=None):
    """loglik(z, covparms, nuggets) with rows sharded over the mesh (the
    data preparation cached per z, as ``loglik_fn`` does)."""
    from ..inference.likelihood import (_dispatch_covmodel, _loglik_closure)
    from ..plan import get_plan
    dtype = torch.float64 if dtype is None else dtype
    mesh, device = _mesh_place(mesh, device)
    plan = get_plan(spec)
    return _loglik_closure(plan, shard_rows(mesh, plan, device=device,
                                            dtype=dtype),
                           _dispatch_covmodel(spec, covmodel, device, dtype),
                           device, dtype, share=row_share(mesh))


def sharded_posterior_core(spec, covmodel="matern", mesh=None, dtype=None,
                           *, device=None):
    """(core, sharded_dev): posterior mean and selected-inverse variances
    with the multifrontal tree sharded over "rows" (the likelihood's
    subtree ranges).  ``core(dev, z, covparms, nuggets)`` returns (mu over
    the ordered latents, the posterior variance diagonal over the
    vertices), whole on every rank.  Multifrontal ('chol'-mode) plans
    only."""
    from ..inference.likelihood import _dispatch_covmodel
    from ..inference.prediction import _posterior_core
    from ..linalg.multifrontal import mf_selinv_diag
    from ..plan import get_plan
    dtype = torch.float64 if dtype is None else dtype
    plan = get_plan(spec)
    if not plan.use_mf:
        raise NotImplementedError("sharded posterior needs the multifrontal "
                                  "('chol'-mode) path")
    mesh, device = _mesh_place(mesh, device)
    cov = _dispatch_covmodel(spec, covmodel, device, dtype)
    sharded = shard_rows(mesh, plan, device=device, dtype=dtype)
    share = row_share(mesh)

    def core(dev, z, covparms, nuggets):
        with torch.no_grad():
            mu, fac = _posterior_core(
                plan, dev, _as_tensor(z, device, dtype), covparms,
                _as_tensor(nuggets, device, dtype).expand(plan.n_obs), cov,
                share)
            return mu, mf_selinv_diag(fac)

    return core, sharded


# ------------------------------------------------------------ run_local ----

def _worker(rank, world_size, fn, args, init, backend, device, timeout,
            results):
    try:
        if device == "cuda":
            # each rank its own card, or cuda:0 for ranks sharing one
            torch.cuda.set_device(rank % torch.cuda.device_count())
            torch.cuda.init()
        else:
            torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                      // world_size))
        dist.init_process_group(backend, init_method=init, rank=rank,
                                world_size=world_size,
                                timeout=timedelta(seconds=timeout))
        out = fn(rank, world_size, *args)
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    results.put((rank, True, out))
    dist.destroy_process_group()


def run_local(fn, world_size, *args, backend="gloo", device="cuda",
              timeout=600.0):
    """Run ``fn(rank, world_size, *args)`` on ``world_size`` local
    processes (start method 'spawn'), each with the default process group
    initialized (``backend``; a ``file://`` store in a fresh temporary
    directory, so concurrent runs never meet) and ``device`` ("cuda", the
    default: rank r on cuda:(r mod the card count), raising when no card
    is visible, as every entry point of the port; or "cpu").  Returns the
    ranks' results in rank order.  ``fn`` and its results must pickle;
    ``fn`` lives in a module the ranks can import.

    If a rank raises, exits without a result or is still running after
    ``timeout`` seconds (also the process group's timeout), every rank is
    stopped and this raises, naming the rank: never a partial result."""
    import multiprocessing as mp

    from ..inference.likelihood import resolve_device
    device = resolve_device(device).type
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="gpvecchia_run_local_")
    init = "file://" + os.path.join(tmp, "store")
    results = ctx.Queue()
    procs = [ctx.Process(target=_worker, daemon=True, args=(
        r, world_size, fn, args, init, backend, device, timeout, results))
        for r in range(world_size)]
    out = {}
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        while len(out) < world_size:
            try:
                rank, ok, res = results.get(timeout=1.0)
            except _queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if dead:
                    try:     # its message may still be on its way
                        rank, ok, res = results.get(timeout=5.0)
                    except _queue.Empty:
                        raise RuntimeError(
                            f"run_local: rank {dead[0]} exited with code "
                            f"{procs[dead[0]].exitcode} and no result")
                elif time.monotonic() > deadline:
                    late = [r for r in range(world_size) if r not in out]
                    raise TimeoutError(f"run_local: rank(s) {late} still "
                                       f"running after {timeout} s")
                else:
                    continue
            if not ok:
                raise RuntimeError(f"run_local: rank {rank} failed:\n{res}")
            out[rank] = res
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(world_size)]
