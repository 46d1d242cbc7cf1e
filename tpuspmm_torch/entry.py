"""Entry points: the panel kernel's launch on one card, and a dry run of
the distributed paths on n ranks.

Counterpart of ``__graft_entry__.py``.

- ``entry(device)`` — the flagship compute path: K1, the panel kernel
  (``csrc/strip_spmm.cu::panel_strip_spmm``), on a pruned-LLM-shaped
  synthetic matrix (1024 x 1024 at 10%, B 256 wide), returned as
  ``(fn, example_args)``.  ``fn`` is the raw launch over the plan's
  arrays, as JAX's is the raw ``_panel_spmm``: no epilogue, so the plan
  keeps the natural row order.
- ``dryrun_multichip(n)`` — n gloo ranks on the CPU, each a process of its
  own on a file store: one least-squares training step on a 2-D mesh
  (forward SpMM, transposed-SpMM backward, all-reduced gradient) and the
  16 schedule x local combos (row-sharded, 2-D, ring, k-shard over the
  xla, tile, panel and pair locals), each gathered and held to the gate.

Usage::

    python -m tpuspmm_torch.entry [--device cuda]    # entry() once
    python -m tpuspmm_torch.entry dryrun [n]         # n gloo ranks (8)

Without a card, ``entry`` exits 2 unless ``--device cpu`` is given.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

import numpy as np
import torch

_GROUP_INDEX = ("group_ptr", "group_kt", "group_slot", "group_order")
# seconds a dry-run rank may take before every rank is stopped
DRYRUN_TIMEOUT_S = 600


class PanelLaunch:
    """``entry()``'s fn: ``fn(kt, st, offs, a_dense, b)`` is C in the
    strip kernel's trash-free layout, (n_st·sm, n_pad) float32, for a B
    padded to (k_pad, n_pad).

    On a CUDA tensor it launches ``panel_strip_spmm`` over the plan's
    group index, which is built from kt, st and offs, so those must be
    ``example_args``' own; on a CPU tensor it runs :meth:`plain`.
    ``launches`` counts the kernel's launches through this entry (it does
    not pass through ``spmm_panel``, whose count does not move)."""

    launches = 0

    def __init__(self, plan):
        self.plan = plan

    def __call__(self, kt, st, offs, a_dense, b):
        if b.device.type == "cpu":
            return self.plain(kt, st, offs, a_dense, b)
        from tpuspmm_torch.kernels import strip_cuda

        plan = self.plan
        arrs = plan.device_arrays(b.device)
        for name, t in (("kt", kt), ("st", st), ("offs", offs)):
            if t.data_ptr() != arrs[name].data_ptr():
                raise ValueError(f"{name} is not the plan's: the kernel "
                                 "reads the group index built from it")
        launch = {k: arrs[k] for k in _GROUP_INDEX}
        launch["a_dense"] = a_dense
        out = strip_cuda.strip_spmm("panel_strip_spmm", launch, b,
                                    plan.n_out_strips, plan.tm, plan.tk)
        PanelLaunch.launches += 1
        return out

    def plain(self, kt, st, offs, a_dense, b):
        """The plain PyTorch version on b's device, in the kernel's
        layout: the slab product with each supertile's trash strip
        dropped."""
        from tpuspmm_torch.kernels.panel_spmm import panel_slab_plain

        plan = self.plan
        slab = panel_slab_plain(
            plan, {"kt": kt, "st": st, "offs": offs, "a_dense": a_dense}, b)
        n_st, sm, tm = plan.n_supertiles, plan.sm, plan.tm
        return slab.reshape(n_st, sm + tm, -1)[:, :sm].reshape(n_st * sm, -1)


def entry(device="cuda"):
    """Return ``(fn, example_args)``: the panel kernel's launch and its
    arguments (kt, st, offs, a_dense, padded B) on ``device``."""
    from tpuspmm_torch.formats import CSR
    from tpuspmm_torch.kernels.common import pad_b, round_up
    from tpuspmm_torch.kernels.panel_spmm import panel_plan_from_container

    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("entry(): no CUDA device (pass device='cpu')")
        if device.index is None:  # the plan's arrays are cached per index
            device = torch.device("cuda", torch.cuda.current_device())
    # pruned-LLM-shaped operand: 90% sparse, 1024 x 1024, B width 256
    a = CSR.random(1024, 1024, density=0.10, seed=0)
    # reorder_rows=False: fn is the raw launch and never runs the
    # un-permute epilogue, so the plan keeps the natural order
    plan = panel_plan_from_container(a, reorder_rows=False)
    b = np.random.default_rng(1).standard_normal((1024, 256)).astype(
        np.float32)
    n_pad = round_up(b.shape[1], 128)
    k_pad = plan.num_k_tiles * plan.tk
    b_padded = pad_b(torch.from_numpy(b), k_pad, n_pad).to(device)
    arrs = plan.device_arrays(device)
    example_args = (arrs["kt"], arrs["st"], arrs["offs"], arrs["a_dense"],
                    b_padded.contiguous())
    return PanelLaunch(plan), example_args


# ---- the dry run ---------------------------------------------------------

def mesh_shape(n: int) -> tuple:
    """JAX's 2-D mesh for n devices: (n // c, c) for the first c of (4, 2)
    that divides n and leaves at least 2 rows, else (n, 1)."""
    for c in (4, 2):
        if n % c == 0 and n // c >= 2:
            return n // c, c
    return n, 1


def _dryrun_rank(rank: int, world: int, store: str, out: str) -> None:
    """One rank of the dry run: writes ``rank<r>.json`` (the loss and each
    combo's gate); rank 0 prints JAX's summary line."""
    import torch.distributed as dist

    from tpuspmm_torch import parallel
    from tpuspmm_torch.formats import CSR
    from tpuspmm_torch.ops import oracle
    from tpuspmm_torch.parallel import multihost
    from tpuspmm_torch.utils.compare import allclose

    torch.set_num_threads(1)  # the ranks share the machine's cores
    multihost.initialize(device="cpu", init_method=f"file://{store}",
                         num_processes=world, process_id=rank)
    try:
        rows_dim, cols_dim = mesh_shape(world)
        mesh2d = parallel.make_mesh((rows_dim, cols_dim), ("rows", "cols"),
                                    device="cpu")
        mesh1d = parallel.make_mesh((world,), ("rows",), device="cpu")

        a = CSR.random(192, 256, density=0.08, seed=3)
        b = np.random.default_rng(0).standard_normal((256, 64)).astype(
            np.float32)
        ref = oracle.spmm_oracle(a, b)

        # the training step: forward SpMM, transposed-SpMM backward,
        # all-reduced dB
        state = parallel.make_train_state(a, n=64, mesh=mesh2d, seed=0)
        state, loss = parallel.lsq_train_step(state, mesh2d, lr=1e-8)
        loss = float(loss)

        schedules = {
            "row": (parallel.spmm_row_sharded, mesh1d, None),
            "2d": (parallel.spmm_2d, mesh2d, "cols"),
            "ring": (parallel.spmm_ring, mesh1d, None),
            "kshard": (parallel.spmm_kshard, mesh1d, None),
        }
        combos = {}
        for sched, (fn, mesh, cols_axis) in schedules.items():
            for local in ("xla", "tile", "panel", "pair"):
                c = fn(a, b, mesh, local=local)
                full = parallel.gather_output(c, mesh, cols_axis=cols_axis)
                combos[f"{sched}_{local}"] = bool(
                    full.shape == ref.shape and allclose(full, ref))
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump({"rank": rank, "mesh": [rows_dim, cols_dim],
                       "loss": loss, "combos": combos}, f)
        dist.barrier()
    finally:
        multihost.shutdown()
    failed = [k for k, ok in combos.items() if not ok]
    if failed or not np.isfinite(loss):
        raise SystemExit(f"rank {rank}: combos off the gate {failed}, "
                         f"loss {loss}")
    if rank == 0:
        print(f"dryrun_multichip({world}): mesh {rows_dim}x{cols_dim} OK, "
              f"{len(combos)}/16 schedule x local combos green, "
              f"loss={loss:.3e}", flush=True)


def dryrun_multichip(n_devices: int) -> dict:
    """Run the dry run on ``n_devices`` gloo ranks (processes of this
    module); print rank 0's summary line and return its record (mesh,
    loss, combos).  Raises if any rank fails."""
    from tpuspmm_torch.parallel import multihost

    with tempfile.TemporaryDirectory(prefix="tpuspmm-dryrun-") as tmp:
        store = os.path.join(tmp, "store")
        logs = multihost.run_ranks(
            lambda r: ["-m", "tpuspmm_torch.entry", str(r), str(n_devices),
                       store, tmp], n_devices, DRYRUN_TIMEOUT_S)
        with open(os.path.join(tmp, "rank0.json")) as f:
            record = json.load(f)
    print(logs[0].strip().splitlines()[-1], flush=True)
    return record


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "dryrun":
        dryrun_multichip(int(argv[1]) if len(argv) > 1 else 8)
        return 0
    if len(argv) == 4 and argv[0].isdigit():  # one rank of the dry run
        _dryrun_rank(int(argv[0]), int(argv[1]), argv[2], argv[3])
        return 0
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from tpuspmm_torch.sweeps.common import resolve_device

    device = resolve_device(args.device)
    if device is None:
        return 2
    fn, example_args = entry(device)
    out = fn(*example_args)
    if device.type == "cuda":
        torch.cuda.synchronize()
    print("entry OK:", tuple(out.shape), out.dtype)
    return 0


if __name__ == "__main__":
    sys.exit(main())
