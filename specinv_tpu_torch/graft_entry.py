"""Entry points: a one-card check of the Griffin-Lim step and a multi-rank
dry run of the parallel layer.

Counterpart of the repository's ``__graft_entry__.py``.  :func:`entry`
returns a Griffin-Lim step on the flagship config and its inputs;
:func:`dryrun_multichip` spawns ``n`` ranks over gloo and runs the eleven
sharded variants of the JAX dry run on a ``data x seq`` mesh.  Run it as::

    python -m specinv_tpu_torch.graft_entry 8 [--device cpu]

By default every rank runs on the card (``cuda:{rank % device_count}``, so
several ranks may share one card: gloo stages their exchanges through host
memory); ``--device cpu`` runs them on the CPU.
"""
from __future__ import annotations

import argparse
import datetime
import multiprocessing as mp
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from .config import canonicalize
from .models.griffin_lim import init as gl_init, step as gl_step
from .ops.stft import make_envelope

# The ranks' file stores, under the checkout's build directory.
STORE_DIR = Path(__file__).resolve().parents[1] / "build" / "graft_entry"
# A collective waits this long for its peers before the rank fails; the
# caller waits this long for the ranks.
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=300)
JOIN_TIMEOUT_S = 900


def _card(device) -> torch.device:
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise ValueError("no CUDA card: the entry points run on the card; pass device='cpu' "
                         "to run them on the CPU")
    return torch.device("cuda", 0)


def entry(device=None):
    """Return ``(fn, example_args)``: four Griffin-Lim iterations on the
    flagship config (n_fft 2048, hann, 64 frames, a batch of 4 clips, seed
    0), from the target and its complex seed to the final signal.  The
    inputs lie on ``device`` (the card by default); ``fn`` runs where its
    inputs lie."""
    dev = _card(device)
    n_fft, num_frames, batch = 2048, 64, 4
    cfg, window_np = canonicalize(
        n_fft // 2 + 1, np.float32, window=np.hanning(n_fft + 1)[:-1].astype(np.float32))
    window = torch.from_numpy(window_np)
    rng = np.random.default_rng(0)
    target = torch.from_numpy(np.abs(rng.standard_normal(
        (batch, num_frames, cfg.num_freqs))).astype(np.float32)).to(dev)
    init_spec = target.to(torch.complex64)
    lr = float(np.float32(0.99 / 1.99))

    def fn(target_tm, init_spec_tm):
        win = window.to(target_tm.device)
        envelope = make_envelope(cfg, win, target_tm.shape[-2])
        state = gl_init(target_tm, init_spec_tm, cfg, win, envelope=envelope)
        for _ in range(4):
            state = gl_step(state, target_tm, lr, cfg, win, envelope)[0]
        return state[0]

    return fn, (target, init_spec)


def _variants(n_devices: int, dev: torch.device):
    """The eleven variants on this rank: ``(data, seq, {name: output})``,
    with the JAX dry run's numpy draws in its order."""
    import specinv_tpu_torch as st

    from .ops.mel import log_mel_transform
    from .parallel import admm_seq, batched, griffin_lim_seq, make_mesh

    seq = 4 if n_devices % 4 == 0 else (2 if n_devices % 2 == 0 else 1)
    data = n_devices // seq
    mesh = make_mesh(data=data, seq=seq, device=dev)

    def draw(shape):
        return torch.from_numpy(np.abs(rng.standard_normal(shape)).astype(np.float32)).to(dev)

    rng = np.random.default_rng(0)
    n_fft, hop = 128, 32
    num_frames, batch = 8 * seq, 2 * data
    spec = draw((batch, n_fft // 2 + 1, num_frames))
    out = {}
    # dp x sp Griffin-Lim: batch over 'data', frames over 'seq'
    out["seq-GL"] = griffin_lim_seq(spec, mesh, max_iter=3, shard_batch_axis=True)
    out["seq-ADMM"] = admm_seq(spec[:1], mesh, max_iter=3, tol=0.0)
    out["dp-GL"] = batched(st.griffin_lim, mesh)(spec, max_iter=3, tol=0.0, verbose=False)
    out["dp-ADMM"] = batched(st.ADMM, mesh)(spec, max_iter=3, tol=0.0, verbose=False)
    # the whole-run kernel per shard (its plain version on the CPU)
    spec4 = draw((batch, 257, 4 * seq))
    out["dp-GL-kernel"] = batched(st.griffin_lim, mesh)(
        spec4, max_iter=2, tol=0.0, verbose=False, backend="kernel", hop_length=128)
    # one raw kernel launch per shard and iteration, the exchange in PyTorch
    spec4s = draw((1, 129, 8 * seq))
    out["seq-GL-kernel"] = griffin_lim_seq(spec4s, mesh, max_iter=2, backend="kernel",
                                           hop_length=128)
    out["seq-ADMM-kernel"] = admm_seq(spec4s, mesh, max_iter=2, backend="kernel",
                                      hop_length=128)
    out["dp-RTISI"] = batched(st.RTISI_LA, mesh)(spec, look_ahead=1, max_iter=2, verbose=False)
    # the stop loss summed over 'data': the unsharded stop iteration
    out["dp-GL-global-stop"] = batched(st.griffin_lim, mesh, global_stop=True)(
        spec, max_iter=6, tol=1e-3, eva_iter=2, verbose=False)
    # dp L-BFGS on log-mel targets; `samples` is the shape inside a shard
    samples = 8 * seq * hop
    trsfn = log_mel_transform(n_fft=n_fft, n_mels=16, sample_rate=4000.0, hop_length=hop)
    noise = np.float32(0.1) * rng.standard_normal((batch, samples)).astype(np.float32)
    mel_tgt = trsfn(torch.from_numpy(noise).to(dev))
    out["dp-LBFGS"] = batched(st.L_BFGS, mesh)(
        mel_tgt, trsfn, [batch // data, samples], outer_max_iter=2, max_iter=2, verbose=False)
    out["dp-mel2audio"] = batched(st.mel_to_audio, mesh)(
        torch.exp(mel_tgt) - 1e-6, n_fft, 4000.0, hop_length=hop, nnls_iter=8, max_iter=2,
        tol=0.0, verbose=False)
    for name, y in out.items():
        if not bool(torch.isfinite(y).all()):
            raise FloatingPointError(f"{name}: non-finite output")
    return data, seq, out


def _rank(rank: int, world: int, store: str, device) -> None:
    """One rank of the dry run; rank 0 writes the result line beside the
    store.  A failure raises, and the process exits nonzero."""
    torch.set_num_threads(1)  # the ranks share the host's cores
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=COLLECTIVE_TIMEOUT)
    try:
        if device is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        else:
            dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        data, seq, out = _variants(world, dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        if rank == 0:
            shapes = ", ".join(f"{name} {tuple(y.shape)}" for name, y in out.items())
            line = f"dryrun_multichip OK: mesh data={data} x seq={seq}, {shapes}"
            Path(store).with_name("line.txt").write_text(line)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Run the sharded inversions over ``n_devices`` ranks and print one
    line naming each variant and its output shape.

    The ranks are spawned processes over gloo (a file store under
    ``build/graft_entry``); the mesh is ``data x seq`` with seq 4 if 4
    divides ``n_devices``, else 2 if 2 does, else 1.  Rank ``r`` runs on
    ``cuda:{r % device_count}``, or on ``device`` when given (``'cpu'``).
    Raises if a rank fails or does not finish."""
    if device is None and not torch.cuda.is_available():
        raise ValueError("no CUDA card: the dry run places its ranks on the card; pass "
                         "device='cpu' to run them on the CPU")
    if device is None or torch.device(device).type == "cuda":
        from .ops.cuda import _build

        _build.build()  # once, before the ranks load it
    STORE_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=STORE_DIR) as tmp:
        store = Path(tmp) / "store"
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_rank, args=(r, n_devices, str(store), device))
                 for r in range(n_devices)]
        for proc in procs:
            proc.start()
        try:
            for proc in procs:
                proc.join(JOIN_TIMEOUT_S)
        finally:
            for proc in procs:
                if proc.is_alive():
                    proc.kill()
                    proc.join()
        codes = [proc.exitcode for proc in procs]
        if codes != [0] * n_devices:
            raise RuntimeError(f"dry-run ranks exited with {codes}")
        line = (Path(tmp) / "line.txt").read_text()
    print(line, flush=True)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        prog="python -m specinv_tpu_torch.graft_entry",
        description="Dry run of the parallel layer over N spawned ranks.")
    parser.add_argument("n_devices", nargs="?", type=int, default=8)
    parser.add_argument("--device", default=None,
                        help="the ranks' device (default: the card; 'cpu' for the CPU)")
    args = parser.parse_args(argv)
    dryrun_multichip(args.n_devices, device=args.device)


if __name__ == "__main__":
    main()
