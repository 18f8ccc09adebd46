"""The port stands alone: no module of ``repro_torch`` (nor
``chip_smoke.py``) imports JAX or the reference package, and the CLIs
run on the CPU when asked and refuse a missing card otherwise."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_importing_every_module_loads_no_jax_and_no_repro():
    code = (
        "import pkgutil, sys, importlib\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 90  # every module was reached


LM_TRAIN_MODULES = (
    "repro_torch.train.optimizer", "repro_torch.train.trainer",
    "repro_torch.data.lm_data", "repro_torch.models.convert",
    "repro_torch.kernels.flash_attention.ops", "repro_torch.kernels.ssd.ops",
)


def test_lm_train_modules_import_no_jax_and_no_repro():
    """The LM training path's modules, alone in a fresh process."""
    code = (
        "import importlib, sys\n"
        f"for n in {LM_TRAIN_MODULES!r}: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


MOE_AND_CONFIG_MODULES = (
    "repro_torch.models.moe", "repro_torch.models.blocks",
    "repro_torch.configs.deepseek_moe_16b",
    "repro_torch.configs.llama4_scout_17b_a16e", "repro_torch.configs.chatglm3_6b",
    "repro_torch.configs.qwen1_5_32b", "repro_torch.configs.mamba2_780m",
    "repro_torch.configs.nemotron_4_340b", "repro_torch.launch.serve",
)


def test_moe_and_config_modules_import_no_jax_and_no_repro():
    """The MoE block and the six configs it completes, alone in a fresh
    process, each config resolving through the registry."""
    code = (
        "import importlib, sys\n"
        f"for n in {MOE_AND_CONFIG_MODULES!r}: importlib.import_module(n)\n"
        "from repro_torch.configs import ARCHS, get_config\n"
        "assert all(get_config(a).name == a for a in ARCHS)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


STREAMING_MODULES = (
    "repro_torch.data.zstore", "repro_torch.data.stream",
    "repro_torch.train.checkpoint", "repro_torch.perf",
    "repro_torch.core.sharded", "repro_torch.core.streaming",
    "repro_torch.core.convert", "repro_torch.launch.train",
)


def test_streaming_modules_import_no_jax_and_no_repro():
    """The block-streamed trainer's modules, alone in a fresh process."""
    code = (
        "import importlib, sys\n"
        f"for n in {STREAMING_MODULES!r}: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


SHARDED_MODULES = (
    "repro_torch.launch.mesh", "repro_torch.core.collectives",
    "repro_torch.core.sharded", "repro_torch.data.corpus",
)


def test_sharded_modules_import_no_jax_and_no_repro():
    """The data-parallel sampler's modules (the grid, the collectives,
    ``ShardedHDP``, the balanced shards), alone in a fresh process; none
    starts a process group when imported."""
    code = (
        "import importlib, sys\n"
        f"for n in {SHARDED_MODULES!r}: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized()\n"
    )
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_sharded_cli_under_torchrun_env_without_card_exits_1_with_message():
    """Under torchrun's environment the default device is still the card:
    with none present the CLI exits 1 before any process group starts."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default device runs")
    env = _env()
    env.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", LOCAL_WORLD_SIZE="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--hdp", "ap",
         "--scale", "0.01", "--iters", "2", "--topics", "20",
         "--max-len", "64"],
        env=env, capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 1
    assert "no CUDA device is present" in out.stderr
    assert "{" not in out.stdout  # no result was printed


SLICE15_MODULES = (
    "repro_torch.configs.shapes", "repro_torch.core.ref",
    "repro_torch.core.direct_assignment", "repro_torch.launch.dryrun",
)


def test_slice15_modules_import_no_jax_and_no_repro():
    """The shape cells, the numpy oracle, the direct-assignment baseline
    and the dry run, alone in a fresh process: importing the dry run sets
    no environment variable (the reference's sets ``XLA_FLAGS``), starts
    no process group and touches no card."""
    code = (
        "import importlib, os, sys\n"
        "before = dict(os.environ)\n"
        f"for n in {SLICE15_MODULES!r}: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "assert dict(os.environ) == before\n"
        "import torch, torch.distributed as dist\n"
        "assert not dist.is_initialized() and not torch.cuda.is_initialized()\n"
    )
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


OBS_MODULES = (
    "repro_torch.obs", "repro_torch.obs.metrics", "repro_torch.obs.trace",
    "repro_torch.obs.diagnostics", "repro_torch.data.deltawire",
    "repro_torch.launch.monitor", "repro_torch.launch.dashboard",
)


def test_obs_deltawire_and_monitor_modules_import_no_jax_and_no_repro():
    """The observability layer, the delta wire format and the monitor,
    alone in a fresh process (their references import no JAX either)."""
    code = (
        "import importlib, sys\n"
        f"for n in {OBS_MODULES!r}: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_sources_never_import_jax_or_repro():
    pat = re.compile(r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)(\.|\s))",
                     re.M)
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [str(f) for f in files if pat.search(f.read_text())]
    assert not offenders, offenders


def test_cli_runs_on_cpu_and_prints_final_json():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--hdp", "ap",
         "--scale", "0.01", "--iters", "2", "--topics", "20",
         "--max-len", "64", "--device", "cpu", "--log-every", "1"],
        env=_env(), capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    summary = json.loads(lines[-1])
    assert summary["corpus"] == "ap" and summary["iters"] == 2
    assert summary["device"] == "cpu" and summary["tokens"] > 0
    assert summary["sec_per_iter"] > 0
    assert sum(line.startswith("{'iter'") for line in lines) == 2


def test_cli_without_card_exits_nonzero_with_message():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default device runs")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--hdp", "ap",
         "--scale", "0.01", "--iters", "2", "--topics", "20",
         "--max-len", "64"],
        env=_env(), capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode != 0
    assert "no CUDA device is present" in out.stderr
    assert "{" not in out.stdout  # no result was printed


TRAIN_LM = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            "hymba-1.5b", "--smoke", "--steps", "3", "--batch", "2", "--seq",
            "32", "--log-every", "1"]


def test_lm_train_cli_runs_on_cpu_and_prints_final_json():
    out = subprocess.run(TRAIN_LM + ["--device", "cpu"], env=_env(),
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    for key in ("arch", "steps", "first_loss", "final_loss", "tokens_per_s",
                "deadline_breaches", "history", "device", "peak_mem_gib"):
        assert key in summary, key
    assert summary["arch"] == "hymba-1.5b" and summary["device"] == "cpu"
    assert summary["steps"] == 3 and summary["tokens_per_s"] > 0
    assert [h["step"] for h in summary["history"]] == [1, 2, 3]
    assert all(h["skipped"] == 0 for h in summary["history"])
    assert summary["first_loss"] == summary["history"][0]["loss"]
    assert summary["peak_mem_gib"] is None  # no card


def test_lm_train_cli_without_card_exits_nonzero_with_message():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default device runs")
    out = subprocess.run(TRAIN_LM, env=_env(), capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert out.returncode != 0
    assert "no CUDA device is present" in out.stderr
    assert "{" not in out.stdout  # no result was printed


def test_train_cli_needs_exactly_one_of_hdp_and_arch():
    from repro_torch.launch import train as T

    for argv in ([], ["--hdp", "ap", "--arch", "hymba-1.5b"]):
        with pytest.raises(SystemExit) as e:
            T.build_parser().parse_args(argv)
        assert e.value.code == 2


SERVE = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "hymba-1.5b", "--smoke", "--requests", "3", "--batch", "2",
         "--prompt-len", "8", "--gen", "4"]


def test_serve_cli_runs_on_cpu_and_prints_final_json():
    out = subprocess.run(SERVE + ["--device", "cpu"], env=_env(),
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["arch"] == "hymba-1.5b" and summary["device"] == "cpu"
    assert summary["batches"] == 2 and summary["logits_finite"]
    assert summary["prefill_tok_s"] > 0 and summary["decode_tok_s"] > 0
    # the first batch is the warm-up, off the clock; the second is timed
    assert summary["warmup_batches"] == 1
    assert len(summary["prefill_tok_s_per_batch"]) == 1
    assert len(summary["decode_tok_s_per_batch"]) == 1
    assert len(summary["sample_output"]) == 4


def test_serve_refuses_a_queue_that_leaves_no_batch_to_time():
    from repro_torch.launch import serve as SV

    args = SV.build_parser().parse_args(
        ["--arch", "hymba-1.5b", "--smoke", "--requests", "2", "--batch", "2",
         "--prompt-len", "8", "--gen", "4", "--device", "cpu"])
    with pytest.raises(ValueError, match="no batch to time"):
        SV.serve(args)


def test_serve_cli_without_card_exits_1_with_message():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default device runs")
    out = subprocess.run(SERVE, env=_env(), capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert out.returncode == 1
    assert "no CUDA device is present" in out.stderr
    assert "{" not in out.stdout  # no result was printed


def test_resolve_device_defaults_to_cuda_and_honours_cpu():
    from repro_torch.device import resolve_device

    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device()


SLICE10_MODULES = (
    "repro_torch.launch.topic_lm", "repro_torch.launch.serve",
    "repro_torch.models.mlp", "repro_torch.configs.paligemma_3b",
    "repro_torch.configs.starcoder2_3b", "repro_torch.configs.musicgen_medium",
)


def test_slice10_modules_import_no_jax_and_no_repro():
    """The topic-conditioned LM, the prefix serving path, the MLP types
    and the new configs, alone in a fresh process."""
    code = (
        "import importlib, sys\n"
        f"for n in {SLICE10_MODULES!r}: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_paligemma_serve_and_train_clis_run_on_cpu():
    """Prefix embeddings through both CLIs at smoke size."""
    serve = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
             "paligemma-3b", "--smoke", "--requests", "3", "--batch", "2",
             "--prompt-len", "8", "--gen", "4", "--device", "cpu"]
    out = subprocess.run(serve, env=_env(), capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["arch"] == "paligemma-3b" and summary["logits_finite"]
    assert len(summary["sample_output"]) == 4
    train = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
             "paligemma-3b", "--smoke", "--steps", "2", "--batch", "2", "--seq",
             "32", "--log-every", "1", "--device", "cpu"]
    out = subprocess.run(train, env=_env(), capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["arch"] == "paligemma-3b" and summary["steps"] == 2
    assert all(h["skipped"] == 0 for h in summary["history"])
