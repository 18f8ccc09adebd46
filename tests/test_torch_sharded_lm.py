"""The sharded LM trainer (``train/sharding.py``), int8 compression
(``train/compression.py``), elastic restart (``train/elastic.py``) and
the HDP sampler's logical-shape checkpoints, on grids of ranks over
``torch.distributed`` on the CPU.

The ranks are this file run as a script (``python
tests/test_torch_sharded_lm.py SPEC NAME RANK WORLD``), on gloo with a
``file://`` rendezvous under the test's ``tmp_path``, one thread each,
at a lower priority, joined with a timeout, under the lock that
``tests/test_torch_sharded.py``'s spawns take (its ``spawn``,
``child_env``, ``one_spawn_at_a_time`` and ``Findings`` are imported
from it). The
reference's values come from one child process a module with 4 host
devices (``XLA_FLAGS`` and ``JAX_PLATFORMS`` in that child's environment
only), which writes an ``.npz``. The pytest process starts no process
group, sets no environment variable and builds no multi-device mesh.

The LM: deepseek-moe-16b's smoke config in float32 at capacity factor
0.5 (slots drop), the reference's initial state (seed 3) carried across
by ``models/convert.py::train_state_from_numpy``, a global batch of 4
sequences of 32 tokens. Two sharded steps on (2, 2) and (2, 1, 2) are
held to the one-process port step and to the reference's single-device
``make_train_step``: the loss within 1e-5, the grad norm within 1e-5
relative, every gathered leaf within 1e-4 of its largest magnitude, and
the set of dropped (token, slot)s of every MoE forward identical. A NaN
in one rank's rows skips the step on every rank, as it does the
one-process step and the reference's. At world 1 the sharded step is
bitwise the one-process step, and ``torchrun`` at world 1 bitwise
``train_lm``.

Compression on (pod, data, model) = (2, 1, 2), on
``tests/test_multidevice.py``'s inputs: the int8 q bitwise, the
residual exactly ``xf - deq`` and within one float32 ulp of max |xf| of
the reference's (whose compiled ``xf - q * scale`` may round once
fewer) on the reference's own per-pod gradients,
``make_compressed_grads``'s mean within 1e-6 relative of the
reference's, compressed against uncompressed below 0.02 relative, and
the wire's bytes 2 an element, half of float32's.

Elastic: a (2, 2) state saved at logical shape, 3 ranks surviving,
``remesh`` to (2, 1) and a restore there give the unsharded parameters
and moments bitwise; a (2, 2) HDP checkpoint restored at world 1 gives
the same logical arrays. ``--ckpt`` resumes the sharded HDP sampler
bitwise on (2, 2) and at world 1, and through ``torchrun`` at 1 and 4
ranks.
"""

from __future__ import annotations

import dataclasses
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_sharded import (  # noqa: E402
    BUCKET, HIST_CAP, K, NICE, ROOT, SPAWN_TIMEOUT_S, V, Findings, _corpus,
    assert_no_failures, child_env, one_spawn_at_a_time)
from test_torch_sharded import spawn as sharded_spawn  # noqa: E402

ARCH = "deepseek-moe-16b"
B, S, STEPS, DROP = 4, 32, 2, 0.5
OPT = dict(lr=1e-3, warmup=20)
LOSS_ATOL, NORM_RTOL, LEAF_REL = 1e-5, 1e-5, 1e-4
NAN_ROW = 3  # a row of the second data shard on (2, 2)
HDP_ITERS = 4

REFERENCE = r"""
import dataclasses, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro import compat
from repro.compat import AxisType
from repro.configs import get_config
from repro.data.lm_data import SyntheticLMStream
from repro.models import lm as JLM
from repro.train import optimizer as JO, trainer as JT
from repro.train.compression import (compressed_psum, init_residuals,
                                     make_compressed_grads, quantize_int8)

ARCH, B, S, STEPS, DROP, OPT, NAN_ROW = {consts}
out = {{}}

def flat(tree, prefix):
    for k, v in tree.items():
        if isinstance(v, dict):
            flat(v, prefix + k + "/")
        else:
            out[prefix + k] = np.asarray(v)

# the LM: two single-device train steps, and a NaN batch
cfg = dataclasses.replace(get_config(ARCH, smoke=True), param_dtype="float32",
                          compute_dtype="float32", capacity_factor=DROP)
params = jax.jit(lambda k: JLM.init_lm(k, cfg)[0])(jax.random.key(3))
state = JT.TrainState(params, *JO.adamw_init(params), jnp.zeros((), jnp.int32))
flat(params, "init/params/")
step = jax.jit(JT.make_train_step(cfg, JO.AdamWConfig(**OPT)))
stream = SyntheticLMStream(cfg.vocab_size, B, S, seed=5)
for i in range(STEPS):
    bt = stream.batch(i)
    for k, v in bt.items():
        out[f"batch{{i}}/{{k}}"] = v
    state, m = step(state, {{k: jnp.asarray(v) for k, v in bt.items()}})
    for k in ("loss", "grad_norm", "skipped"):
        out[f"step{{i}}/{{k}}"] = np.asarray(m[k])
flat(state.params, "final/params/")
bad = {{k: jnp.asarray(v) for k, v in stream.batch(0).items()}}
bad["mask"] = bad["mask"].astype(jnp.float32).at[NAN_ROW, 0].set(jnp.nan)
_, m = step(JT.TrainState(params, *JO.adamw_init(params), jnp.zeros((), jnp.int32)), bad)
out["nan/skipped"] = np.asarray(m["skipped"])

# compression: tests/test_multidevice.py's inputs on (pod, data, model) = (2, 1, 2)
mesh = compat.make_mesh((2, 1, 2), ("pod", "data", "model"),
                        axis_types=(AxisType.Auto,) * 3)
rng = np.random.default_rng(0)
cp = {{"w": jnp.asarray(rng.standard_normal((16, 8)), jnp.float32)}}
def loss_fn(p, b):
    return jnp.mean((b["x"] @ p["w"] - b["y"]) ** 2)
cb = {{"x": jnp.asarray(rng.standard_normal((8, 16)), jnp.float32),
      "y": jnp.asarray(rng.standard_normal((8, 8)), jnp.float32)}}
resid = init_residuals(jax.eval_shape(lambda: cp))

def per_pod(p, b, r):
    _, g = jax.value_and_grad(loss_fn)(p, b)
    xf = g["w"].astype(jnp.float32) + r["w"]
    amax = jax.lax.pmax(jnp.max(jnp.abs(xf)), "pod")
    q = quantize_int8(xf, jnp.maximum(amax, 1e-30) / 127.0)
    mean, new_r = compressed_psum(g["w"], "pod", r["w"])
    return xf[None], q[None], new_r[None], mean[None]

with mesh:
    parts = jax.jit(compat.shard_map(
        per_pod, mesh=mesh, in_specs=(P(), P("pod"), P()),
        out_specs=(P("pod"),) * 4, axis_names=frozenset({{"pod"}}),
        check_vma=False))(cp, cb, resid)
    lc, gc, _ = jax.jit(make_compressed_grads(loss_fn, mesh, compress=True))(cp, cb, resid)
    lx, gx, _ = jax.jit(make_compressed_grads(loss_fn, mesh, compress=False))(cp, cb, resid)
for name, a in zip(("xf", "q", "resid", "mean"), parts):
    out["comp/" + name] = np.asarray(a)
out.update({{"comp/w": np.asarray(cp["w"]), "comp/x": np.asarray(cb["x"]),
            "comp/y": np.asarray(cb["y"]), "comp/gc": np.asarray(gc["w"]),
            "comp/gx": np.asarray(gx["w"]), "comp/lc": np.asarray(lc),
            "comp/lx": np.asarray(lx)}})
np.savez(sys.argv[1], **out)
print("OK")
"""


def spawn(tmp_path, tmp_path_factory, name: str, world: int, spec: dict) -> list:
    """Run ``world`` ranks of this file on ``spec``; each rank's findings,
    none of them a failure."""
    results = sharded_spawn(tmp_path, tmp_path_factory, name, world, spec,
                            script=__file__)
    assert_no_failures(results)
    return results


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's LM steps and compression, from one child process
    with 4 host devices."""
    out = tmp_path_factory.mktemp("sharded_lm_reference") / "reference.npz"
    code = REFERENCE.format(consts=(ARCH, B, S, STEPS, DROP, OPT, NAN_ROW))
    with one_spawn_at_a_time(tmp_path_factory):
        p = subprocess.run(
            [sys.executable, "-c", code, str(out)], capture_output=True,
            text=True, timeout=SPAWN_TIMEOUT_S, cwd=ROOT,
            env=child_env(XLA_FLAGS="--xla_force_host_platform_device_count=4",
                          JAX_PLATFORMS="cpu"))
    assert p.returncode == 0, p.stdout + p.stderr
    return out


def test_four_ranks_hold_the_step_compression_and_restarts(tmp_path, tmp_path_factory,
                                                           reference):
    results = spawn(tmp_path, tmp_path_factory, "world4", 4,
                    {"reference": str(reference), "ckpt": str(tmp_path / "ck")})
    for name, info in results[0]["info"].items():
        print(name, info)


def test_world_one_is_bitwise_the_one_process_step(tmp_path, tmp_path_factory,
                                                   reference):
    results = spawn(tmp_path, tmp_path_factory, "world1", 1,
                    {"reference": str(reference), "ckpt": str(tmp_path / "ck")})
    print(results[0]["info"])


def _torchrun_lines(ranks: int, args: list) -> list[str]:
    out = subprocess.run(
        [*NICE, sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(ranks), "-m", "repro_torch.launch.train", *args],
        env=child_env(), capture_output=True, text=True, timeout=SPAWN_TIMEOUT_S,
        cwd=ROOT)
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout.strip().splitlines()


def _torchrun(ranks: int, args: list) -> list:
    return [json.loads(x) for x in _torchrun_lines(ranks, args) if x.startswith("{\"")]


@pytest.mark.parametrize("ranks", [1, 4])
def test_torchrun_hdp_resumes_from_its_checkpoint(tmp_path, ranks):
    """``train_hdp_sharded`` through the CLI: 4 iterations checkpointing
    each, its checkpoints after the second removed, and a rerun of 2
    from the second logs iterations 3 and 4 as the uninterrupted run
    did (the log-likelihood of the whole state, the active topics, the
    flag topic's tokens)."""
    ck = tmp_path / "ck"
    base = ["--hdp", "ap", "--scale", "0.01", "--topics", "20", "--max-len", "64",
            "--device", "cpu", "--log-every", "1", "--ckpt", str(ck)]
    whole = _torchrun_lines(ranks, [*base, "--iters", "4"])
    for step in (3, 4):
        shutil.rmtree(ck / f"step_{step}")
    part = _torchrun_lines(ranks, [*base, "--iters", "2"])
    assert "restored HDP state at iteration 2" in part

    def logged(lines):
        return [x for x in lines if x.startswith("{'iter'")]

    assert len(logged(whole)) == 4 and logged(part) == logged(whole)[2:]


@pytest.mark.parametrize("ranks", [1, 4])
def test_torchrun_trains_the_lm_and_prints_one_summary(ranks):
    """``torchrun`` over 1 and 4 ranks prints one summary; at world 1 its
    history is bitwise the one-process ``train_lm``'s."""
    args = ["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2",
            "--batch", str(B), "--seq", str(S), "--log-every", "1"]
    summaries = _torchrun(ranks, args)
    assert len(summaries) == 1, summaries
    s = summaries[0]
    assert s["ranks"] == ranks and s["backend"] == "gloo" and s["steps"] == 2
    assert s["grid"] == ({"data": 1, "model": 1} if ranks == 1 else
                         {"data": 2, "model": 2})
    assert len(s["history"]) == 2 and s["tokens_per_s"] > 0
    assert all(np.isfinite(h["loss"]) and h["skipped"] == 0 for h in s["history"])
    if ranks == 1:
        one = subprocess.run(
            [*NICE, sys.executable, "-m", "repro_torch.launch.train", *args],
            env=child_env(), capture_output=True, text=True, timeout=SPAWN_TIMEOUT_S,
            cwd=ROOT)
        assert one.returncode == 0, one.stdout + one.stderr
        hist = json.loads(one.stdout.strip().splitlines()[-1])["history"]
        assert [(h["loss"], h["grad_norm"]) for h in s["history"]] == [
            (h["loss"], h["grad_norm"]) for h in hist]
    else:
        assert s["bytes_by_collective"]["psum grads [batch axes]"] > 0


# -- the ranks ------------------------------------------------------------------------

def _port_cfg():
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(ARCH, smoke=True), param_dtype="float32",
                               compute_dtype="float32", capacity_factor=DROP)


def _nested(ref, prefix):
    out = {}
    for key in ref.files:
        if key.startswith(prefix):
            node = out
            *path, leaf = key[len(prefix):].split("/")
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = ref[key]
    return out


def _full_state(ref, cfg):
    from repro_torch.models.convert import train_state_from_numpy

    params = _nested(ref, "init/params/")
    zeros = {k: np.zeros_like(v) for k, v in _flat_np(params).items()}
    return train_state_from_numpy(params, _unflat(zeros), _unflat(zeros), 0, cfg,
                                  device="cpu")


def _flat_np(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_np(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _unflat(flat):
    out = {}
    for key, v in flat.items():
        node = out
        *path, leaf = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v
    return out


def _batch(ref, i, nan=False):
    bt = {k: ref[f"batch{i}/{k}"] for k in ("tokens", "targets", "mask")}
    if nan:
        bt["mask"] = bt["mask"].astype(np.float32)
        bt["mask"][NAN_ROW, 0] = np.nan
    return bt


def _record_places():
    """Wrap ``models.moe.places`` to record each call's keep."""
    from repro_torch.models import moe as MOE

    calls = []
    orig = MOE.places

    def wrapped(idx, cfg, tokens):
        out = orig(idx, cfg, tokens)
        calls.append(out[3].clone())
        return out

    MOE.places = wrapped
    return calls, lambda: setattr(MOE, "places", orig)


def _one_process_steps(ref, cfg, nan=False):
    """The one-process port's STEPS steps (or one NaN step): (metrics of
    each step, final state, the keep of every MoE call)."""
    from repro_torch.train import optimizer as TO
    from repro_torch.train import trainer as TT

    state = _full_state(ref, cfg)
    step = TT.make_train_step(cfg, TO.AdamWConfig(**OPT))
    calls, undo = _record_places()
    ms = []
    try:
        for i in range(1 if nan else STEPS):
            state, m = step(state, TT.batch_tensors(_batch(ref, i, nan), torch.device("cpu")))
            ms.append({k: v.clone() for k, v in m.items()})
    finally:
        undo()
    return ms, state, calls


def _sharded_steps(ref, cfg, comm, nan=False):
    from repro_torch.train import optimizer as TO
    from repro_torch.train import sharding as SHD
    from repro_torch.train import trainer as TT

    layout = SHD.Layout(cfg, comm)
    state = SHD.shard_train_state(_full_state(ref, cfg), layout)
    step = SHD.make_sharded_train_step(TO.AdamWConfig(**OPT), layout, B)
    calls, undo = _record_places()
    ms = []
    try:
        for i in range(1 if nan else STEPS):
            bt = SHD.local_batch(comm.grid, _batch(ref, i, nan))
            state, m = step(state, TT.batch_tensors(bt, torch.device("cpu")))
            ms.append({k: v.clone() for k, v in m.items()})
    finally:
        undo()
    return ms, state, layout, calls


def _leaf_err(got, want):
    g, w = (np.asarray(torch.as_tensor(x).detach(), np.float64) for x in (got, want))
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))


def _check_lm(ref, comm, tag, found: Findings, one):
    """Two sharded steps against the one-process step and the reference."""
    from repro_torch.train import sharding as SHD

    cfg = _port_cfg()
    ms, state, layout, calls = _sharded_steps(ref, cfg, comm)
    one_ms, one_state, one_calls = one
    worst = {"loss": 0.0, "grad_norm": 0.0, "leaf_port": 0.0, "leaf_ref": 0.0}
    for i, (m, om) in enumerate(zip(ms, one_ms)):
        for want, src in ((float(om["loss"]), "port"), (float(ref[f"step{i}/loss"]), "ref")):
            err = abs(float(m["loss"]) - want)
            worst["loss"] = max(worst["loss"], err)
            found.true(err <= LOSS_ATOL, f"{tag} step {i} loss vs {src}: {err}")
        for want, src in ((float(om["grad_norm"]), "port"),
                          (float(ref[f"step{i}/grad_norm"]), "ref")):
            err = abs(float(m["grad_norm"]) - want) / want
            worst["grad_norm"] = max(worst["grad_norm"], err)
            found.true(err <= NORM_RTOL, f"{tag} step {i} grad norm vs {src}: {err}")
        found.true(int(m["skipped"]) == int(om["skipped"]) == int(ref[f"step{i}/skipped"]) == 0,
                   f"{tag} step {i} skipped")
    full = SHD.gather_params(state, layout)
    for k, p in full.items():
        e1 = _leaf_err(p, one_state.params[k].detach())
        rk = ("final/params/blocks/" + k.split(".", 2)[2].replace(".", "/")
              if k.startswith("blocks.") else "final/params/" + k.replace(".", "/"))
        want = ref[rk][int(k.split(".")[1])] if k.startswith("blocks.") else ref[rk]
        e2 = _leaf_err(p, want)
        worst["leaf_port"], worst["leaf_ref"] = (max(worst["leaf_port"], e1),
                                                 max(worst["leaf_ref"], e2))
        found.true(e1 <= LEAF_REL and e2 <= LEAF_REL, f"{tag} {k}: {e1} {e2}")
    # the dropped (token, slot)s of every MoE forward, in global order
    split = SHD.batch_split(comm.grid, {"tokens": (B, S)})[1]
    n = cfg.num_layers
    dropped = 0
    for j in range(n):
        keep = calls[j]
        if split:
            keep = comm.all_gather(keep.to(torch.uint8), split, 0).bool()
        found.equal(keep, one_calls[j], f"{tag} moe call {j} keep")
        dropped += int((~keep).sum())
    found.true(dropped > 0, f"{tag}: no slot dropped")
    worst["dropped_slots"] = dropped
    found.info[tag] = worst


def _check_nan(ref, comm, tag, found: Findings):
    from repro_torch.train import sharding as SHD

    cfg = _port_cfg()
    layout = SHD.Layout(cfg, comm)
    before = SHD.shard_train_state(_full_state(ref, cfg), layout)
    before = {k: p.detach().clone() for k, p in before.params.items()}
    ms, state, _, _ = _sharded_steps(ref, cfg, comm, nan=True)
    one_ms, _, _ = _one_process_steps(ref, cfg, nan=True)
    found.true(int(ms[0]["skipped"]) == int(one_ms[0]["skipped"]) ==
               int(ref["nan/skipped"]) == 1, f"{tag}: skipped")
    found.true(state.step == 1, f"{tag}: step count")
    for k, p in state.params.items():
        found.equal(p.detach(), before[k], f"{tag}: {k} moved")


def _check_compression(ref, comm, tag, found: Findings):
    from repro_torch.train import compression as COMP

    pod = comm.grid.index("pod")
    w = torch.from_numpy(ref["comp/w"])
    batch = {"x": torch.from_numpy(ref["comp/x"]), "y": torch.from_numpy(ref["comp/y"])}

    def loss_fn(p, b):
        return torch.mean((b["x"] @ p["w"] - b["y"]) ** 2)

    # the reference's own per-pod gradients through the port's psum
    xf = torch.from_numpy(ref["comp/xf"][pod])
    comm.sent.clear()
    mean, resid = COMP.compressed_psum(comm, xf, "pod", torch.zeros_like(xf))
    amax = comm.pmax(xf.abs().max().reshape(1), "pod")[0]
    q = COMP.quantize_int8(xf, torch.clamp_min(amax, 1e-30) / 127.0)
    found.equal(q, torch.from_numpy(ref["comp/q"][pod]), f"{tag}: q")
    deq = q.float() * (torch.clamp_min(amax, 1e-30) / 127.0)
    found.equal(resid, xf - deq, f"{tag}: residual is xf - deq")
    # XLA may fuse q * scale into the subtraction (one rounding fewer), so
    # the reference's residual is held within one float32 ulp of max |xf|
    ulp = float(np.spacing(np.float32(xf.abs().max())))
    r_err = float((resid - torch.from_numpy(ref["comp/resid"][pod])).abs().max())
    found.true(r_err <= ulp, f"{tag}: residual vs the reference's {r_err}")
    err = _leaf_err(mean, ref["comp/mean"][pod])
    found.true(err <= 1e-6, f"{tag}: mean of the reference's xf {err}")
    wire = comm.sent[COMP.BYTES_WIRE]
    found.true(wire == 2 * xf.numel(), f"{tag}: wire bytes {wire}")
    # make_compressed_grads end to end
    resid0 = COMP.init_residuals({"w": w})
    comm.sent.clear()
    lc, gc, rc = COMP.make_compressed_grads(loss_fn, comm, compress=True)({"w": w}, batch, resid0)
    lx, gx, _ = COMP.make_compressed_grads(loss_fn, comm, compress=False)({"w": w}, batch, resid0)
    plain = comm.sent[COMP.BYTES_PLAIN]
    found.true(plain == 4 * w.numel() and comm.sent[COMP.BYTES_WIRE] * 2 == plain,
               f"{tag}: bytes {dict(comm.sent)}")
    e_c, e_x = _leaf_err(gc["w"], ref["comp/gc"]), _leaf_err(gx["w"], ref["comp/gx"])
    found.true(e_c <= 1e-6 and e_x <= 1e-6, f"{tag}: means {e_c} {e_x}")
    rel = float((gc["w"] - gx["w"]).abs().max() / gx["w"].abs().max())
    found.true(rel < 0.02, f"{tag}: compressed vs uncompressed {rel}")
    found.true(float(rc["w"].abs().max()) > 0, f"{tag}: no residual")
    found.true(abs(float(lc) - float(ref["comp/lc"])) <= 1e-6 * abs(float(ref["comp/lc"])),
               f"{tag}: loss")
    found.info[tag] = {"mean_rel": e_c, "vs_plain": rel, "bytes": dict(comm.sent),
                       "resid_vs_reference_in_ulps": r_err / ulp}


def _hdp(comm):
    from repro_torch.core import hdp as H
    from repro_torch.core.sharded import ShardedHDP

    cfg = H.HDPConfig(K=K, V=V, bucket=BUCKET, z_impl="cuda", hist_cap=HIST_CAP,
                      alias_in_kernel="off")
    sh = ShardedHDP(comm, cfg)
    tokens, mask = _corpus()
    rows = sh.doc_rows(tokens.shape[0])
    return sh, tokens[rows], mask[rows]


def _logical(sh, state):
    from repro_torch.core.sharded import MODEL

    out = {"z": sh.comm.all_gather(state.z, sh.grid.axes, 0)}
    for f in ("n", "phi", "varphi"):
        out[f] = sh.comm.all_gather(getattr(state, f), MODEL, 1)
    out.update(psi=state.psi, l=state.l)
    return out


def _check_hdp_resume(comm, ckpt, tag, found: Findings):
    """2 iterations, a checkpoint, a restore and 2 more: bitwise 4."""
    sh, tokens, mask = _hdp(comm)
    whole = sh.init_state(4, tokens, mask)
    for _ in range(HDP_ITERS):
        whole = sh.iteration(whole, tokens, mask)
    part = sh.init_state(4, tokens, mask)
    for _ in range(HDP_ITERS // 2):
        part = sh.iteration(part, tokens, mask)
    sh.save(ckpt, part)
    saved = _logical(sh, part)
    part = sh.restore(ckpt, tokens.shape[1], doc_ranks=comm.grid.world_size)
    found.true(part.it == HDP_ITERS // 2 and part.seed == 4, f"{tag}: it, seed")
    for _ in range(HDP_ITERS // 2):
        part = sh.iteration(part, tokens, mask)
    for f in ("z", "n", "phi", "varphi", "psi", "l"):
        found.equal(getattr(part, f), getattr(whole, f), f"{tag}: {f}")
    found.true(part.it == whole.it == HDP_ITERS, f"{tag}: iterations")
    return saved


def _rank_main(spec_path: str, name: str, rank: int, world: int) -> None:
    torch.set_num_threads(1)
    import torch.distributed as dist

    tmp = Path(spec_path).parent
    spec = json.loads(Path(spec_path).read_text())
    dist.init_process_group("gloo", init_method=f"file://{tmp / (name + '.pg')}",
                            rank=rank, world_size=world)
    found = Findings()
    try:
        (_run_world4 if world == 4 else _run_world1)(spec, rank, tmp, found)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    (tmp / f"{name}.rank{rank}.out.json").write_text(json.dumps(
        {"failures": found.failures, "checks": found.checks, "info": found.info}))


def _run_world1(spec, rank, tmp, found: Findings) -> None:
    from repro_torch.launch.mesh import Grid
    from repro_torch.train import sharding as SHD

    ref = np.load(spec["reference"])
    cfg = _port_cfg()
    comm = SHD.make_comm(Grid((1, 1), ("data", "model"), 0), "gloo", torch.device("cpu"))
    one_ms, one_state, one_calls = _one_process_steps(ref, cfg)
    ms, state, _, calls = _sharded_steps(ref, cfg, comm)
    for i, (m, om) in enumerate(zip(ms, one_ms)):
        for k in ("loss", "grad_norm", "skipped"):
            found.equal(m[k], om[k], f"world 1 step {i} {k}")
    for k, p in state.params.items():
        found.equal(p.detach(), one_state.params[k].detach(), f"world 1 {k}")
        found.equal(state.mu[k], one_state.mu[k], f"world 1 mu {k}")
        found.equal(state.nu[k], one_state.nu[k], f"world 1 nu {k}")
    for j, (a, b) in enumerate(zip(calls, one_calls)):
        found.equal(a, b, f"world 1 moe call {j} keep")
    found.true(len(calls) == len(one_calls) > 0, "world 1 moe calls")
    found.true(not comm.sent, f"world 1 sent {dict(comm.sent)}")
    _check_hdp_resume(comm, spec["ckpt"], "hdp world 1", found)
    found.info["world 1"] = {"loss": [float(m["loss"]) for m in ms]}


def _run_world4(spec, rank, tmp, found: Findings) -> None:
    from repro_torch.core import hdp as H
    from repro_torch.core.collectives import Collectives
    from repro_torch.core.sharded import ShardedHDP
    from repro_torch.launch.mesh import AXES_2D, AXES_3D, Grid
    from repro_torch.train import elastic as EL
    from repro_torch.train import sharding as SHD

    cpu = torch.device("cpu")
    ref = np.load(spec["reference"])
    cfg = _port_cfg()
    one = _one_process_steps(ref, cfg)
    g22 = SHD.make_comm(Grid((2, 2), AXES_2D, rank), "gloo", cpu)
    g212 = SHD.make_comm(Grid((2, 1, 2), AXES_3D, rank), "gloo", cpu)
    _check_lm(ref, g22, "lm (2, 2)", found, one)
    _check_lm(ref, g212, "lm (2, 1, 2)", found, one)
    _check_nan(ref, g22, "nan (2, 2)", found)
    _check_compression(ref, g212, "compression (2, 1, 2)", found)
    hdp_ckpt = spec["ckpt"] + "_hdp"
    saved = _check_hdp_resume(g22, hdp_ckpt, "hdp (2, 2)", found)

    # elastic: save on (2, 2), lose rank 3, remesh the 3 survivors
    layout = SHD.Layout(cfg, g22)
    full = _full_state(ref, cfg)
    SHD.save_sharded(spec["ckpt"], SHD.shard_train_state(
        dataclasses.replace(full, step=3), layout), layout)
    if rank == 3:
        return
    grid = EL.remesh([0, 1, 2], rank, backend="gloo", device=cpu,
                     init_method=f"file://{tmp / 'remesh3.pg'}")
    if grid is None:
        return
    found.true(grid.shape == (2, 1) and grid.rank == rank, f"remesh grid {grid}")
    layout2 = SHD.Layout(cfg, SHD.make_comm(grid, "gloo", cpu))
    state = EL.reshard_state(spec["ckpt"], layout2, cpu)
    found.true(state.step == 3, "restored step")
    got = SHD.gather_params(state, layout2)
    for k, p in full.params.items():
        found.equal(got[k], p.detach(), f"elastic (2, 1) {k}")
        found.equal(state.mu[k], layout2.shard(k, full.mu[k]), f"elastic mu {k}")
        found.equal(state.params[k].detach(), layout2.shard(k, p.detach()),
                    f"elastic shard {k}")
    # the (2, 2) HDP checkpoint restored at world 1
    grid1 = EL.remesh([0], rank, backend="gloo", device=cpu,
                      init_method=f"file://{tmp / 'remesh1.pg'}")
    if grid1 is None:
        return
    comm1 = Collectives(grid1, "gloo", cpu)
    sh = ShardedHDP(comm1, H.HDPConfig(K=K, V=V, bucket=BUCKET, z_impl="cuda",
                                       hist_cap=HIST_CAP, alias_in_kernel="off"))
    tokens, _ = _corpus()
    back = sh.restore(hdp_ckpt, tokens.shape[1])
    for f, want in saved.items():
        found.equal(getattr(back, f), want, f"hdp (2, 2) at world 1: {f}")


if __name__ == "__main__":
    _rank_main(sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
