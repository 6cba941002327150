"""Multi-process runs of the port's parallel layer for the CPU tests.

Imports torch, numpy and the port only (never JAX): each spawned process is
one rank of a gloo process group over a file store, runs every case of a
job on its mesh, and writes its results to ``rank{r}.npz``.  The test files
(``test_torch_seq.py``, ``test_torch_batch.py``) spawn a job once per module
with :func:`run_job` and hold rank 0's results against the JAX package; every
rank's results must be equal.  The inputs are made from seeds with numpy
(:func:`case_spec`), so both sides see the same spectrograms.
"""
from __future__ import annotations

import datetime
import multiprocessing as mp
from pathlib import Path

import numpy as np
import torch

JOIN_TIMEOUT_S = 300
# a collective waits this long for its peers, so that a deadlock (a backward
# pass whose exchanges do not pair up) fails the job instead of hanging it
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=120)


def signal(n, batch=None, seed=0, dtype=np.float64):
    """The seeded white-noise clip(s) of ``tests.helpers.make_signal``."""
    shape = (n,) if batch is None else (batch, n)
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def stft_mag(x, n_fft, **kw):
    """``|torch.stft|`` of a numpy signal, as a numpy array."""
    window = kw.pop("window", None)
    if isinstance(window, np.ndarray):
        window = torch.from_numpy(window)
    return torch.stft(torch.from_numpy(x), n_fft, window=window, return_complex=True,
                      **kw).abs().numpy()


def hann(n_fft):
    return torch.hann_window(n_fft, dtype=torch.float64).numpy()


def case_signal(case):
    """The clip(s) of a case (numpy): white noise, or speech-like clips."""
    n, batch, seed = case.get("n", 22050), case.get("batch"), case.get("seed", 0)
    dtype = np.float32 if case.get("f32") else np.float64
    if case.get("speech"):
        from specinv_tpu_torch.utils.corpus import make_speech_like

        clips = [make_speech_like(n, seed=seed + b) for b in range(batch or 1)]
        return np.stack(clips).astype(dtype) if batch else clips[0].astype(dtype)
    return signal(n, batch, seed, dtype)


def case_spec(case):
    """The spectrogram of a case: its clip(s) through ``torch.stft``.

    ``speech``: speech-like clips (``utils/corpus``; ADMM amplifies rounding
    on white noise, so its cases run on these).  ``seeded``: a complex
    spectrogram, the magnitude with a seeded random phase, so that both
    packages start from the same complex seed (in float32 the SPSI seed's
    cumulative phase sums round differently in XLA and torch).
    """
    dtype = np.float32 if case.get("f32") else np.float64
    x = case_signal(case)
    if case.get("scale_rows"):  # heterogeneous clips: per-clip losses differ
        rng = np.random.default_rng(7)
        x = x * (1.0 + 9.0 * rng.random((x.shape[0], 1)))
    kw = dict(case.get("stft", {}))
    if kw.pop("hann", False):
        kw["window"] = hann(case.get("n_fft", 512))
    spec = stft_mag(x, case.get("n_fft", 512), **kw).astype(dtype)
    if case.get("frames"):  # RTISI-LA doubles a rounding difference per frame
        spec = np.ascontiguousarray(spec[..., : case["frames"]])
    if case.get("seeded"):
        phase = np.random.default_rng(11).uniform(0, 2 * np.pi, spec.shape)
        spec = (spec * np.exp(1j * phase)).astype(np.complex64 if case.get("f32")
                                                  else np.complex128)
    return spec


def grad_loss(y, x):
    """A gradient case's loss: the mean square of the waveform ``y`` against
    the clip ``x`` over their common length (``test_sharding.py``'s)."""
    n = min(y.shape[-1], x.shape[-1])
    return ((y[..., :n] - x[..., :n]) ** 2).mean()


def call_kwargs(case):
    """The entry point's keyword arguments: the case's, plus its STFT ones."""
    kw = dict(case.get("call", {}))
    stft = dict(case.get("stft", {}))
    if stft.pop("hann", False):
        kw["window"] = hann(case.get("n_fft", 512))
    kw.update(stft)
    return kw


# world size -> {case: ...}.  Seq cases: algo 'gl' / 'admm', mesh (data,
# seq); batch cases: fn 'gl' / 'admm' / 'rtisi', the wrapper's options.  A
# ``grad`` case saves d grad_loss / d spec on each rank in place of the
# waveform.  GRAD: tests/test_sharding.py's gradient geometry (n_fft 256,
# hop 128, 8192 samples).
GRAD = dict(grad=True, n=8192, n_fft=256, stft=dict(hop_length=128))
SEQ_JOBS = {
    2: {
        "gl_center_hann": dict(algo="gl", stft=dict(hann=True), call=dict(max_iter=12)),
        "gl_nocenter_hann": dict(algo="gl", stft=dict(hann=True, center=False),
                                 call=dict(max_iter=12)),
        "gl_center_boxcar": dict(algo="gl", call=dict(max_iter=12)),
        "gl_nocenter_boxcar": dict(algo="gl", stft=dict(center=False), call=dict(max_iter=12)),
        "admm_reflect": dict(algo="admm", speech=True, call=dict(max_iter=8)),
        "gl_early_stop": dict(algo="gl", call=dict(max_iter=60, tol=1.0, eva_iter=5)),
        "admm_early_stop": dict(algo="admm", speech=True,
                                call=dict(max_iter=30, tol=1e-3, eva_iter=5)),
        "gl_kernel": dict(algo="gl", f32=True, seeded=True, stft=dict(hop_length=128),
                          call=dict(max_iter=6, backend="kernel")),
        "admm_kernel": dict(algo="admm", f32=True, seeded=True, speech=True,
                            stft=dict(hop_length=128), call=dict(max_iter=6, backend="kernel")),
        "gl_kernel_early_stop": dict(algo="gl", f32=True, seeded=True,
                                     stft=dict(hop_length=128),
                                     call=dict(max_iter=40, tol=1.0, eva_iter=5,
                                               backend="kernel")),
        "gl_grad": dict(algo="gl", **GRAD, call=dict(max_iter=3)),
        "admm_grad": dict(algo="admm", speech=True, **GRAD, call=dict(max_iter=3)),
        "gl_grad_tol": dict(algo="gl", **GRAD, call=dict(max_iter=12, tol=1.0, eva_iter=2)),
        # float32, as test_sharding.py's 'pallas4' against 'fft' and remat
        # cases: the kernel against the fft path, remat against none
        **{f"{algo}_grad_{backend}{'_remat' * remat}": dict(
            algo=algo, f32=True, **GRAD, call=dict(max_iter=3, backend=backend, remat=remat))
           for algo in ("gl", "admm") for backend in ("kernel", "fft") for remat in (0, 1)},
    },
    4: {
        **{f"{algo}_{pm}": dict(algo=algo, speech=algo == "admm", stft=dict(pad_mode=pm),
                                call=dict(max_iter=8))
           for algo in ("gl", "admm")
           for pm in ("reflect", "constant", "replicate", "circular")},
        "gl_moderate_tol": dict(algo="gl", n=44100, f32=True, seeded=True,
                                call=dict(max_iter=60, tol=3e-3, eva_iter=5)),
        "gl_data_seq": dict(algo="gl", mesh=(2, 2), batch=4,
                            call=dict(max_iter=10, shard_batch_axis=True)),
        "gl_data_seq_early_stop": dict(algo="gl", mesh=(2, 2), batch=4, scale_rows=True,
                                       call=dict(max_iter=40, tol=3e-2, eva_iter=5,
                                                 shard_batch_axis=True)),
        "too_many_shards": dict(algo="gl", n=2000, call=dict(max_iter=2), error=True),
        # from a seeded complex spectrogram: from the magnitude alone both
        # packages' float64 SPSI seeds differ by the order of their phase
        # sums, and 3 iterations carry that to 2.3e-8 of the gradient's max
        # for GL reflect here (the unsharded calls' too; 1.4e-11 with JAX's
        # seed values), 8.6e-9 for ADMM constant
        **{f"gl_grad_{pm}": dict(algo="gl", grad=True, seeded=True, stft=dict(pad_mode=pm),
                                 call=dict(max_iter=3))
           for pm in ("reflect", "constant", "replicate", "circular")},
        **{f"admm_grad_{pm}": dict(algo="admm", grad=True, seeded=True, speech=True,
                                   stft=dict(pad_mode=pm), call=dict(max_iter=3))
           for pm in ("reflect", "constant", "replicate", "circular")},
        # 12 frames over 4 shards of 4: the last shard holds only padding
        # (valid_t 0), its rows inert forward and backward
        "admm_grad_padding_shard": dict(algo="admm", grad=True, speech=True, n=1920,
                                        stft=dict(center=False), call=dict(max_iter=3)),
        **{f"admm_grad_padding_shard_{backend}": dict(
            algo="admm", grad=True, f32=True, speech=True, n=1920, stft=dict(center=False),
            call=dict(max_iter=3, backend=backend)) for backend in ("kernel", "fft")},
        "gl_data_seq_grad": dict(algo="gl", grad=True, seeded=True, mesh=(2, 2), batch=4,
                                 call=dict(max_iter=3, shard_batch_axis=True)),
        "gl_data_seq_grad_kernel": dict(algo="gl", grad=True, seeded=True, f32=True,
                                        mesh=(2, 2), batch=4,
                                        call=dict(max_iter=3, shard_batch_axis=True,
                                                  backend="kernel")),
    },
}

BATCH_JOB = {
    "gl": dict(fn="gl", batch=8, call=dict(max_iter=10, tol=0.0, verbose=False)),
    "admm": dict(fn="admm", batch=8, speech=True,
                 call=dict(max_iter=6, tol=0.0, verbose=False)),
    "rtisi": dict(fn="rtisi", batch=8, n=8192, frames=12,
                  call=dict(look_ahead=2, max_iter=4, verbose=False)),
    "kernel": dict(fn="gl", batch=8, f32=True, seeded=True,
                   call=dict(max_iter=4, tol=0.0, verbose=False, backend="kernel")),
    "uneven_3": dict(fn="gl", batch=3, call=dict(max_iter=8, tol=0.0, verbose=False)),
    "uneven_9": dict(fn="gl", batch=9, call=dict(max_iter=8, tol=0.0, verbose=False)),
    "uneven_early_stop": dict(fn="gl", batch=6,
                              call=dict(max_iter=40, tol=1e-2, eva_iter=5, verbose=False)),
    "global_stop_gl": dict(fn="gl", batch=4, scale_rows=True, global_stop=True,
                           call=dict(max_iter=60, tol=3e-2, eva_iter=5, verbose=False)),
    "global_stop_admm": dict(fn="admm", batch=4, speech=True, scale_rows=True, global_stop=True,
                             call=dict(max_iter=60, tol=3e-2, eva_iter=5, verbose=False)),
    "global_stop_uneven": dict(fn="gl", batch=6, global_stop=True,
                               call=dict(max_iter=40, tol=1e-2, eva_iter=5, verbose=False)),
    "gspmd": dict(fn="gl", batch=8, gspmd=True,
                  call=dict(max_iter=6, tol=0.0, verbose=False)),
    "gspmd_early_stop": dict(fn="gl", batch=4, scale_rows=True, gspmd=True,
                             call=dict(max_iter=60, tol=3e-2, eva_iter=5, verbose=False)),
    # dp L-BFGS on a log-mel target and dp mel_to_audio, at the sizes of
    # __graft_entry__.dryrun_multichip (mel_inputs), 2 clips per rank
    "lbfgs": dict(fn="lbfgs", batch=8, call=dict(outer_max_iter=2, max_iter=2, verbose=False)),
    "mel_to_audio": dict(fn="mel_to_audio", batch=8,
                         call=dict(hop_length=32, nnls_iter=8, max_iter=2, tol=0.0,
                                   verbose=False)),
    "gl_grad": dict(fn="gl", batch=8, grad=True, call=dict(max_iter=4, tol=0.0, verbose=False)),
    "admm_grad": dict(fn="admm", batch=8, speech=True, grad=True,
                      call=dict(max_iter=4, tol=0.0, verbose=False)),
    "rtisi_grad": dict(fn="rtisi", batch=8, n=8192, frames=12, grad=True,
                       call=dict(look_ahead=2, max_iter=2, verbose=False)),
    "gl_grad_uneven": dict(fn="gl", batch=6, grad=True,
                           call=dict(max_iter=4, tol=0.0, verbose=False)),
}
MEL_FNS = ("lbfgs", "mel_to_audio")
# __graft_entry__.dryrun_multichip's mel geometry (its 4-device seq axis):
# n_fft 128, hop 32, 16 mels at 4 kHz, 8 * 4 * 32 samples per clip
MEL_N_FFT, MEL_HOP, MEL_BANDS, MEL_SR, MEL_SAMPLES = 128, 32, 16, 4000.0, 1024


def mel_inputs(batch):
    """The port's log-mel transform (float64) and the log-mel targets of
    ``batch`` seeded clips of 0.1 x white noise (``(B, M, T)``)."""
    from specinv_tpu_torch.ops.mel import log_mel_transform

    fn = log_mel_transform(n_fft=MEL_N_FFT, n_mels=MEL_BANDS, sample_rate=MEL_SR,
                           hop_length=MEL_HOP, dtype=np.float64)
    x = 0.1 * np.random.default_rng(0).standard_normal((batch, MEL_SAMPLES))
    return fn, fn(torch.from_numpy(x))


def mel_call(case, mesh=None, rows=slice(None)):
    """A mel case through ``batched`` on ``mesh``, or (no mesh) through the
    port's entry point as it is on ``rows`` of the case's input."""
    import specinv_tpu_torch as st
    from specinv_tpu_torch.parallel import batched

    fn, logmel = mel_inputs(case["batch"])
    lbfgs = case["fn"] == "lbfgs"
    target = logmel if lbfgs else torch.exp(logmel) - 1e-6
    entry = st.L_BFGS if lbfgs else st.mel_to_audio
    if mesh is not None:
        entry, n = batched(entry, mesh), case["batch"] // mesh.shape["data"]
    else:
        target = target[rows]
        n = target.shape[0]
    if lbfgs:  # samples: the waveform's shape inside each shard
        return entry(target, fn, [n, MEL_SAMPLES], **case["call"])
    return entry(target, MEL_N_FFT, MEL_SR, **case["call"])


# The stop losses over 4 ranks: each rank's slice of these seeded arrays.
LOSS_SHAPE = (4, 6, 33)


def loss_inputs():
    rng = np.random.default_rng(5)
    out = np.abs(rng.standard_normal(LOSS_SHAPE))
    tgt = np.abs(rng.standard_normal(LOSS_SHAPE))
    stats = np.abs(rng.standard_normal((4, 2)))
    return out, tgt, stats


def run_case(fn, case, **kw):
    """``fn(spec, **kw, **call)`` on the case's input: the waveform, or for
    a ``grad`` case d grad_loss / d spec (numpy)."""
    spec = torch.from_numpy(case_spec(case)).requires_grad_(bool(case.get("grad")))
    y = fn(spec, **kw, **call_kwargs(case))
    if not case.get("grad"):
        return y.detach().numpy()
    grad_loss(y, torch.from_numpy(case_signal(case))).backward()
    return spec.grad.numpy()


def _seq_case(case, device):
    from specinv_tpu_torch.parallel import admm_seq, griffin_lim_seq, make_mesh

    data, seq = case.get("mesh", (1, torch.distributed.get_world_size()))
    mesh = make_mesh(data=data, seq=seq, device=device)
    return run_case(admm_seq if case["algo"] == "admm" else griffin_lim_seq, case, mesh=mesh)


def _batch_case(case, mesh):
    import specinv_tpu_torch as st
    from specinv_tpu_torch.parallel import batched

    if case["fn"] in MEL_FNS:
        return mel_call(case, mesh).numpy()
    fn = {"gl": st.griffin_lim, "admm": st.ADMM, "rtisi": st.RTISI_LA}[case["fn"]]
    wrapped = batched(fn, mesh, gspmd=case.get("gspmd", False),
                      global_stop=case.get("global_stop", False))
    return run_case(wrapped, case)


def _mesh_facts(device):
    """make_mesh's shapes and errors, and the stop losses on a 4x1 mesh."""
    from specinv_tpu_torch.parallel import make_mesh
    from specinv_tpu_torch.utils import collective
    from specinv_tpu_torch.utils import runner

    facts = {}
    facts["shape_2x2"] = np.array(list(make_mesh(data=2, seq=2, device=device).shape.values()))
    mesh = make_mesh(device=device)
    facts["shape_default"] = np.array(list(mesh.shape.values()))
    for name, kw in (("err_too_big", dict(data=8, seq=1)), ("err_indivisible", dict(seq=3))):
        try:
            make_mesh(device=device, **kw)
        except ValueError as e:
            facts[name] = np.array(str(e))
    out, tgt, stats = (torch.from_numpy(a) for a in loss_inputs())
    r = mesh.index("data")
    with collective.bound(mesh):
        facts["psum_mse"] = runner.stop_loss_fn(("data",))(out[r], tgt[r]).numpy()
        loss_fn, _ = runner.stats_eval_fns("sc", tgt[r], ("data",))
        facts["stats_loss"] = loss_fn(stats[r], None).numpy()
    return facts


def _worker(rank, world, store, out_dir, job):
    torch.set_num_threads(1)
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=COLLECTIVE_TIMEOUT)
    try:
        results = {}
        if job == "batch":
            from specinv_tpu_torch.parallel import make_mesh

            mesh = make_mesh(data=world, device="cpu")
            for name, case in BATCH_JOB.items():
                results[name] = _batch_case(case, mesh)
            results.update(_mesh_facts("cpu"))
        else:
            for name, case in SEQ_JOBS[world].items():
                if case.get("error"):
                    try:
                        _seq_case(case, "cpu")
                    except ValueError as e:
                        results[name] = np.array(str(e))
                    continue
                results[name] = _seq_case(case, "cpu")
        np.savez(Path(out_dir) / f"rank{rank}.npz", **results)
    finally:
        torch.distributed.destroy_process_group()


def run_job(job: str, world: int, out_dir) -> dict:
    """Spawn ``world`` ranks of ``job`` ('seq' or 'batch'), join them, and
    return rank 0's results; raise if a rank failed or the ranks disagree."""
    out_dir = Path(out_dir)
    ctx = mp.get_context("spawn")
    store = out_dir / "store"
    procs = [ctx.Process(target=_worker, args=(r, world, str(store), str(out_dir), job))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(JOIN_TIMEOUT_S)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    if codes != [0] * world:
        raise RuntimeError(f"{job} ranks exited with {codes}")
    ranks = [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(world)]
    for r, res in enumerate(ranks[1:], 1):
        for name, v in res.items():
            if not np.array_equal(v, ranks[0][name]):
                raise AssertionError(f"rank {r} disagrees with rank 0 on {name}")
    return ranks[0]
