"""The port's research examples (``examples/*_torch.py``) against the JAX
package's (``examples/*.py``): the cases of ``tests/test_examples.py`` but
``arc_walk`` (numpy and matplotlib only, no sibling), each run through its
argv surface on the CPU, with parity checked on the same inputs.

Tolerances: per-dimension moments of the same float32 samples at rtol 1e-5
on mean and variance and 1e-4 on skew and kurtosis, atol 1e-6 (sums in
another order; the skew of a symmetric sample is a small difference of large
sums), as ``chip_smoke.py`` holds kernel 3. One step of
``kurtosis_single_example``'s loss on a given x and noise at rtol 1e-5, its
gradient at rtol 1e-4 with an atol of 1e-6 of its largest entry (the
analytic backward against JAX's autodiff of the same moments). The swarm's
fitness at rtol 1e-4 / atol 1e-6. ``gamma_example``'s printed table (numpy on
both sides) and ``quick_camera_streamer``'s PNGs equal."""

import importlib
import os

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")
CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True)
def _examples_on_path(monkeypatch):
    monkeypatch.syspath_prepend(EXAMPLES)


def _example(name):
    return importlib.import_module(name)


def _close_moments(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got[:2], want[:2], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[2:], want[2:], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("distribution", ["exponential", "gamma", "normal", "uniform"])
def test_kurtosis_example_matches_jax(tmp_path, capsys, distribution):
    """The same seeded samples; the port's moments (kernel 3's plain version on
    the CPU) against the JAX package's perdim_moments; the same table header."""
    from trustedai_cl_vae_ad_tpu.ops.moments import perdim_moments

    out = tmp_path / "k.png"
    res = _example("kurtosis_example_torch").main(
        ["-n", "500", "-d", "4", "--distribution", distribution, "-o", str(out), *CPU])
    printed = capsys.readouterr().out
    assert out.stat().st_size > 0
    assert printed.splitlines()[0] == f"{distribution}, N=500, d=4"
    want = np.stack([np.asarray(m) for m in perdim_moments(res["x"])])
    _close_moments(np.stack(res["moments"]), want)
    sampler = _example("kurtosis_example").DISTRIBUTIONS[distribution][0]
    np.testing.assert_array_equal(
        res["x"], sampler(np.random.RandomState(0), 500, 4).astype(np.float32))


def _jax_single_loss(target):
    """The loss of examples/kurtosis_single_example.py with the noise given."""
    import jax.numpy as jnp

    from trustedai_cl_vae_ad_tpu.ops.moments import perdim_moments

    def loss_fn(x, noise):
        eps = x + 1e-5 * noise
        meu, _var, skew, kurtosis = perdim_moments(eps)
        return (jnp.mean((kurtosis - target) ** 2) + jnp.sqrt(jnp.sum(meu ** 2))
                + jnp.mean(skew ** 2))

    return loss_fn


@pytest.mark.parametrize("init", ["uniform", "gaussian"])
def test_kurtosis_single_step_matches_jax(init):
    import jax

    from trustedai_cl_vae_ad_tpu.ops.moments import perdim_moments

    rng = np.random.RandomState(3)
    x = (rng.uniform(size=(16, 32)) if init == "uniform" else
         2.0 * rng.normal(size=32)[None] + rng.normal(size=(16, 32))).astype(np.float32)
    noise = rng.normal(size=(16, 32)).astype(np.float32)
    single = _example("kurtosis_single_example_torch")
    loss, aux, grad = single.value_and_grad(torch.from_numpy(x), torch.from_numpy(noise), 3.0)
    want_loss, want_grad = jax.value_and_grad(_jax_single_loss(3.0))(x, noise)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    want_grad = np.asarray(want_grad)
    np.testing.assert_allclose(grad.numpy(), want_grad, rtol=1e-4,
                               atol=1e-6 * np.abs(want_grad).max())
    kurt = np.asarray(perdim_moments(x + 1e-5 * noise)[3])
    np.testing.assert_allclose([float(a) for a in aux[:3]],
                               [kurt.min(), kurt.max(), kurt.mean()], rtol=1e-4)


def test_kurtosis_single_example_cli(tmp_path, capsys):
    out = tmp_path / "ks.png"
    res = _example("kurtosis_single_example_torch").main(
        ["-l", "4", "-b", "8", "-n", "10", "-o", str(out), *CPU])
    lines = capsys.readouterr().out.splitlines()
    assert [line.split(",")[0] for line in lines if line.startswith("Epoch")] == [
        "Epoch: 0", "Epoch: 9"]
    assert out.stat().st_size > 0
    assert res["x"].shape == (8, 4) and torch.isfinite(res["x"]).all()
    assert not torch.equal(res["x"], res["x0"])


def test_pso_fitness_matches_jax_vmap():
    """One launch on the swarm laid side by side gives jax.vmap's per-particle fitness."""
    import jax
    import jax.numpy as jnp

    from trustedai_cl_vae_ad_tpu.ops.moments import perdim_moments

    def fitness(x):  # examples/kurtosis_pso.py's
        meu, _var, skew, kurt = perdim_moments(x)
        return jnp.mean((kurt - 1.8) ** 2) + jnp.mean(skew ** 2) + jnp.mean(meu ** 2)

    pos = np.random.RandomState(4).normal(size=(8, 16, 4)).astype(np.float32)
    got = _example("kurtosis_pso_torch").swarm_fitness(torch.from_numpy(pos), 1.8).numpy()
    want = np.asarray(jax.vmap(fitness)(pos))
    assert got.shape == (8,)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_kurtosis_pso_cli(tmp_path, capsys):
    out = tmp_path / "pso.png"
    res = _example("kurtosis_pso_torch").main(
        ["-p", "8", "-b", "16", "-d", "4", "-n", "10", "-o", str(out), *CPU])
    printed = capsys.readouterr().out
    assert "kurtosis" in printed.lower() and out.stat().st_size > 0
    fits = [float(line.split("= ")[1]) for line in printed.splitlines()
            if line.startswith("step")]
    assert len(fits) == 2 and fits[1] <= fits[0]
    assert res["gbest"].shape == (16, 4)
    pso = _example("kurtosis_pso_torch")
    assert float(res["gbest_fit"]) == pytest.approx(
        float(pso.swarm_fitness(res["gbest"][None], 1.8)[0]), rel=1e-6)


def _table(text):
    """The printed lines before the timing loop's."""
    return [line for line in text.splitlines() if not line.startswith("Time Delta")]


def test_gamma_example_matches_jax(monkeypatch, capsys):
    """Under one np.random.seed both examples print the same table."""
    np.random.seed(5)
    monkeypatch.setattr("sys.argv", ["gamma_example.py", "-n", "500"])
    _example("gamma_example").main()
    want = capsys.readouterr().out
    np.random.seed(5)
    cdf, seconds = _example("gamma_example_torch").main(["-n", "500"])
    got = capsys.readouterr().out
    assert _table(got) == _table(want) and "95%" in got
    assert "Get Value from Probability" in got and seconds > 0
    assert sum(line.startswith("Time Delta for 1000 runs") for line in got.splitlines()) == 1


def test_quick_camera_streamer_matches_jax(monkeypatch, tmp_path):
    """The three synthetic frames' PNGs byte for byte."""
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    monkeypatch.setattr("sys.argv", ["quick_camera_streamer.py", "synthetic", "-n", "3",
                                     "-o", str(jax_dir)])
    _example("quick_camera_streamer").main()
    assert _example("quick_camera_streamer_torch").main(
        ["synthetic", "-n", "3", "-o", str(port_dir)]) == 3
    names = sorted(os.listdir(port_dir))
    assert names == sorted(os.listdir(jax_dir)) and len(names) == 3
    for name in names:
        assert (port_dir / name).read_bytes() == (jax_dir / name).read_bytes()


@pytest.mark.parametrize("name", ["kurtosis_example_torch", "kurtosis_single_example_torch",
                                  "kurtosis_pso_torch"])
def test_examples_default_to_the_card(name, tmp_path, capsys):
    """--device defaults to cuda; without a CUDA device the parser refuses."""
    with pytest.raises(SystemExit):
        _example(name).main(["-o", str(tmp_path / "x.png")])
    assert "no CUDA device" in capsys.readouterr().err
