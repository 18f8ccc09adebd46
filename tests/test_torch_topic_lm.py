"""The port's topic-conditioned LM (``launch/topic_lm.py``) against the
reference's ``examples/topic_conditioned_lm.py``.

Its LM side is held to the reference at L2: from the reference's own
initial state (``init_train_state(jax.random.key(0))``, carried across by
``train_state_from_numpy``) and one shared theta, the port's
``run_lm`` takes the same float32 steps as the reference's
``make_train_step`` on the same batches: every step's loss within 1e-4
(measured: 3.8e-6 at most over 20 steps), and its mean of the last 20
within 1e-4 of the example's own ``run_lm``, which draws the batches,
``proj`` and the prefix itself. The HDP side runs the port's sampler,
whose chain cannot replay JAX's random streams (L3); the example at the
reference's size must still show a positive conditioning gain.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data.synthetic import planted_topics_corpus as jax_planted  # noqa: E402
from repro.models.config import LMConfig as JaxLMConfig  # noqa: E402
from repro.train import optimizer as JO  # noqa: E402
from repro.train import trainer as JT  # noqa: E402
from repro_torch.launch import topic_lm as TLM  # noqa: E402
from repro_torch.models.convert import train_state_from_numpy  # noqa: E402

CPU = torch.device("cpu")
LOSS_ATOL = 1e-4
STEPS = 20


def reference_example():
    path = Path(__file__).resolve().parents[1] / "examples" / "topic_conditioned_lm.py"
    spec = importlib.util.spec_from_file_location("topic_conditioned_lm", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def corpus():
    ours = TLM.make_corpus()
    theirs, _ = jax_planted(np.random.default_rng(3), D=150, V=80, K_true=4,
                            doc_len=(20, 32), topic_sharpness=0.03)
    np.testing.assert_array_equal(ours.tokens, theirs.tokens)
    np.testing.assert_array_equal(ours.mask, theirs.mask)
    assert (ours.num_docs, ours.V) == (150, 80)
    return ours


def test_lm_config_is_the_examples():
    for prefix in (0, 1):
        tc = TLM.lm_config(80, prefix)
        jc = JaxLMConfig(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                         head_dim=16, d_ff=128, vocab_size=80, prefix_len=prefix,
                         loss_chunk=32)
        for f in ("num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim",
                  "d_ff", "vocab_size", "prefix_len", "loss_chunk", "mlp_type",
                  "param_dtype", "compute_dtype"):
            assert getattr(tc, f) == getattr(jc, f), f
    assert (TLM.OPT.lr, TLM.OPT.warmup) == (3e-3, 10)


@pytest.mark.parametrize("conditioned", [False, True])
def test_lm_steps_match_the_reference(corpus, conditioned):
    """A shared theta (16 topics) and the reference's initial state: the
    port's steps against the reference's trainer on the port's batches,
    step by step, and the mean against the example's own run."""
    theta = None
    if conditioned:
        theta = np.random.default_rng(21).dirichlet(np.full(16, 0.3), 150).astype(np.float32)
    tc = TLM.lm_config(corpus.V, 1 if conditioned else 0)
    jc = JaxLMConfig(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                     head_dim=16, d_ff=128, vocab_size=corpus.V,
                     prefix_len=tc.prefix_len, loss_chunk=32)
    js = JT.init_train_state(jax.random.key(0), jc)
    ts = train_state_from_numpy(*(jax.tree.map(np.asarray, t)
                                  for t in (js.params, js.mu, js.nu)),
                                int(js.step), tc, device="cpu")
    mean, losses = TLM.run_lm(corpus, theta, CPU, steps=STEPS, seed=0, state=ts)
    assert len(losses) == STEPS

    jstep = jax.jit(JT.make_train_step(jc, JO.AdamWConfig(lr=3e-3, warmup=10)))
    want = []
    for bt in TLM.lm_batches(corpus, theta, STEPS, tc.d_model, seed=0):
        assert ("embeds" in bt) == conditioned
        js, m = jstep(js, {k: jnp.asarray(v) for k, v in bt.items()})
        want.append(float(m["loss"]))
    np.testing.assert_allclose(losses, want, rtol=0, atol=LOSS_ATOL)

    example_mean = reference_example().run_lm(corpus, theta, steps=STEPS, seed=0)
    np.testing.assert_allclose(mean, example_mean, rtol=0, atol=LOSS_ATOL)


def test_the_example_at_the_references_size_gains(capsys):
    """The reference's sizes and seeds, the port's sampler (dense z-step
    on the CPU) and LM: conditioning on the inferred mixtures lowers the
    loss. Prints the reference's four lines and a JSON line."""
    out = TLM.run("cpu")
    assert 1 < out["active_topics"] < 16
    assert np.isfinite(out["unconditioned_loss"]) and np.isfinite(out["conditioned_loss"])
    assert out["conditioned_loss"] < out["unconditioned_loss"]
    assert out["gain"] == pytest.approx(out["unconditioned_loss"] - out["conditioned_loss"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "corpus: 150 docs, 3884 tokens"
    assert lines[1].startswith("HDP inferred") and lines[4].startswith("conditioning gain")


def test_infer_topics_rows_are_mixtures(corpus):
    theta, active = TLM.infer_topics(corpus, CPU, iters=5)
    assert theta.shape == (150, 16) and theta.dtype == np.float32
    np.testing.assert_allclose(theta.sum(1), 1.0, rtol=1e-6)
    assert 1 <= active <= 16


def test_the_card_is_the_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        TLM.main([])
