"""The port's SPAD noise model (noise/spad.py) and its draws
(geometry/sampling.py: split, uniform, choice, poisson) against the JAX
package's, on the CPU.

JAX runs with x64 off, as its runner runs it: under the conftest's x64
its uniform and choice draw float64 bits.  The draws that feed a
comparison (split, uniform) are held bit for bit; the photon counts by
distribution, as tests/test_noise.py holds JAX's own (its cumsum rounds
otherwise than torch's, and its Poisson sampler is a rejection loop)."""

import numpy as np
import pytest
import torch

import jax

from nlos_surface_optimization_tpu.experiments import run as jrun
from nlos_surface_optimization_tpu.noise import SpadParams as JParams
from nlos_surface_optimization_tpu.noise import spad_model as jspad_model
from nlos_surface_optimization_tpu.noise import (
    spad_noisy_transients as jspad_noisy,
)

from nlos_surface_optimization_torch.experiments import run as prun
from nlos_surface_optimization_torch.geometry import sampling
from nlos_surface_optimization_torch.noise import (
    SpadParams,
    spad_model,
    spad_noisy_transients,
)

torch.set_num_threads(1)

KEY = sampling.key(99)
NO_JITTER = (np.array([0.0]), np.array([1.0]))


def _ideal(B=200, center=80, width=6.0):
    x = np.arange(B)
    return np.exp(-((x - center) / width) ** 2 / 2)


def _model(ideal, jitters, counts, params):
    return spad_model(KEY, ideal, jitters, counts, params,
                      device="cpu").numpy()


def _jax(fn, *args):
    with jax.enable_x64(False):
        return np.asarray(fn(jax.random.key(99), *args))


# ------------------------------------------------------------ draws


@pytest.mark.parametrize("num", [2, 5, 4096])
def test_split_matches_jax(num):
    with jax.enable_x64(False):
        want = np.asarray(jax.random.key_data(
            jax.random.split(jax.random.key(99), num)))
        inner = np.asarray(jax.random.key_data(jax.random.split(
            jax.random.split(jax.random.key(99), num)[num - 1], 5)))
    got = sampling.split(KEY, num)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(sampling.split(got, 5)[num - 1].numpy(),
                                  inner)


@pytest.mark.parametrize("shape", [(7,), (3, 5), (2000,), (1000, 3)])
def test_uniform_matches_jax(shape):
    with jax.enable_x64(False):
        k = jax.random.split(jax.random.key(17), 3)[2]
        want = np.asarray(jax.random.uniform(k, shape))
    key = sampling.split(sampling.key(17), 3)[2]
    got = sampling.uniform(key, shape).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    # a batch of keys draws each key's own
    both = sampling.uniform(sampling.split(sampling.key(17), 3), shape)
    np.testing.assert_array_equal(both[2].numpy(), got)


@pytest.mark.parametrize("B,M", [(200, 3000), (1200, 20000)])
def test_choice_follows_jax(B, M):
    """The same u, the same search: the draws agree but where the two
    cumsums round a boundary apart."""
    t = _ideal(B, center=0.4 * B) + 0.01 * np.random.RandomState(0).rand(B)
    with jax.enable_x64(False):
        p = jax.numpy.asarray(t, jax.numpy.float32)
        want = np.asarray(jax.random.choice(jax.random.key(5), B, (M,),
                                            p=p / p.sum()))
    p = torch.tensor(t, dtype=torch.float32)
    got = sampling.choice(sampling.key(5), B, (M,), p / p.sum()).numpy()
    assert got.shape == want.shape
    assert (got != want).mean() < 1e-3
    assert np.abs(got - want).max() <= 1


@pytest.mark.parametrize("lam", [0.0, 7.5, 75.0, 37500.0])
def test_poisson_is_a_function_of_the_key(lam):
    k = sampling.split(KEY, 4)
    a = sampling.poisson(k[1], lam, (4000,))
    b = sampling.poisson(k[1], lam, (4000,))
    assert torch.equal(a, b) and a.dtype == torch.float32
    if lam == 0:
        assert not a.any()
        return
    assert not torch.equal(a, sampling.poisson(k[2], lam, (4000,)))
    mean, var = float(a.mean()), float(a.var())
    sd = (lam / 4000) ** 0.5
    assert abs(mean - lam) < 5 * sd
    assert abs(var / lam - 1) < 0.15


# ------------------------------------------------------------ the model
# (the six checks of tests/test_noise.py, on the port)


def test_spad_counts_concentrate_at_peak():
    params = SpadParams(num_photons=3000, mu_noise=0.0, pileup=False)
    out = _model(_ideal(), *NO_JITTER, params)
    assert out.sum() > 0
    assert abs(int(np.argmax(out)) - 80) <= 3
    assert out[56:104].sum() / out.sum() > 0.95
    # every photon of a jitter-free, pdp-1 model lands: M counts
    assert out.sum() == 3000


def test_spad_jitter_broadens():
    ideal = _ideal(width=2.0)
    params = SpadParams(num_photons=4000, mu_noise=0.0, pileup=False)
    no_jit = _model(ideal, *NO_JITTER, params)
    jbins = np.arange(-20, 21).astype(np.float64)
    jit = _model(ideal, jbins * params.dt, np.ones_like(jbins), params)

    def std_of(h):
        x = np.arange(len(h))
        p = h / h.sum()
        mu = (x * p).sum()
        return np.sqrt(((x - mu) ** 2 * p).sum())

    assert std_of(jit) > std_of(no_jit) * 2


def test_spad_background_level():
    B, M, mu = 150, 1000, 50.0
    params = SpadParams(num_photons=M, mu_noise=mu, pileup=False, pdp=0.0)
    out = _model(np.ones(B), np.array([0.0]), np.array([200.0]), params)
    expected = mu * M / 200.0 * B / 1.0
    assert 0.8 * expected < out.mean() < 1.2 * expected


def test_spad_pileup_reduces_counts():
    base = SpadParams(num_photons=2000, mu_noise=0.0)
    with_pu = _model(_ideal(), *NO_JITTER, base)
    no_pu = _model(_ideal(), *NO_JITTER, base._replace(pileup=False))
    assert with_pu.sum() < no_pu.sum()
    # the dead time after a detection spans HO / RR = 80 pulses: JAX's
    # count on these inputs, and the port's, is 25
    want = _jax(lambda k: jspad_model(k, _ideal(), *NO_JITTER,
                                      JParams(num_photons=2000,
                                              mu_noise=0.0)))
    assert with_pu.sum() == want.sum() == 25


def test_spad_batch_rescale():
    t = np.stack([_ideal(), 2 * _ideal(center=120)], 0)
    params = SpadParams(num_photons=500, mu_noise=0.0, pileup=False)
    out = spad_noisy_transients(KEY, t, *NO_JITTER, params,
                                device="cpu").numpy()
    assert out.shape == t.shape
    for i in range(2):
        assert 0.3 * t[i].sum() < out[i].sum() < 3.0 * t[i].sum()


def test_noise_scene_injects_spad_and_descends(tmp_path):
    """run_experiment('noise') on the CPU pushes the GT through the SPAD
    model before optimizing, and the loop runs."""
    seen = {}
    orig = prun._apply_spad_noise

    def spy(gt, spec, workdir, key, num_photons, log, device):
        noisy = orig(gt, spec, workdir, key, num_photons, log, device)
        seen["ideal"] = np.asarray(gt).copy()
        seen["noisy"] = np.asarray(noisy).copy()
        return noisy

    prun._apply_spad_noise = spy
    try:
        state, history = prun.run_experiment(
            "noise", str(tmp_path / "noise"), max_iters=2,
            scan_resolution=8, sample_num=300, gt_sample_num=2000,
            spad_photons=800, log=lambda m: None, device="cpu")
    finally:
        prun._apply_spad_noise = orig

    ideal, noisy = seen["ideal"], seen["noisy"]
    assert ideal.shape == noisy.shape and noisy.dtype == np.float64
    rel = np.abs(noisy - ideal).sum() / max(ideal.sum(), 1e-30)
    assert rel > 0.01, "SPAD injection left the transients unchanged"
    tot_i, tot_n = ideal.sum(axis=1), noisy.sum(axis=1)
    live = tot_i > 0
    assert np.all(tot_n[live] / tot_i[live] < 20.0)
    assert np.all(noisy[~live] == 0)
    assert len(history["l2"]) == 2 and all(np.isfinite(history["l2"]))

    # the same GT through JAX's injection: by distribution, the same
    # per-row photon totals within Poisson spread, the peaks in place
    spec = jrun.SCENES["noise"]
    with jax.enable_x64(False):
        want = jrun._apply_spad_noise(ideal, spec, str(tmp_path),
                                      jax.random.key(0), 800,
                                      lambda m: None)
    # (800 photons a row over a 2,000-sample GT: a row's peak is not
    # placed to a few bins)
    _same_distribution(noisy, want, ideal, 800, rows=False)


def _same_distribution(got, want, ideal, M, rows=True):
    """Rows of rescaled counts, turned back into counts: per-row totals
    within 5 sd of their Poisson spread; the rows' sums, bin by bin, a
    two-sample chi-square of one a degree of freedom (at most 1.3); with
    ``rows`` each row's peak within 3 bins (after a 9-bin box)."""
    live = ideal.sum(axis=1) > 0
    scale = M / ideal.sum(axis=1)[live, None]
    a, b = got[live] * scale, want[live] * scale
    ta, tb = a.sum(axis=1), b.sum(axis=1)
    assert np.all(np.abs(ta - tb) < 5 * np.sqrt(ta + tb)), (ta, tb)
    sa, sb = a.sum(0), b.sum(0)
    n = sa + sb > 0
    chi2 = ((sa - sb)[n] ** 2 / (sa + sb)[n]).mean()
    assert chi2 < 1.3, chi2
    if rows:
        box = np.ones(9) / 9
        pa = [np.argmax(np.convolve(r, box, "same")) for r in a]
        pb = [np.argmax(np.convolve(r, box, "same")) for r in b]
        assert np.abs(np.subtract(pa, pb)).max() <= 3, (pa, pb)


# ------------------------------------------------------------ port only


def test_spad_matches_jax_in_distribution():
    """The runner's calibration and pileup=False on rows of a scene's
    shape (1,200 bins): the per-row photon totals and the peaks agree."""
    t, counts = jrun._find_jitter_calibration("/nonexistent")
    rng = np.random.RandomState(4)
    B = 1200
    ideal = np.stack([_ideal(B, c, w) for c, w in
                      zip(rng.uniform(500, 900, 6), rng.uniform(3, 12, 6))])
    jp = JParams(num_photons=2000, pileup=False)
    want = _jax(lambda k: jspad_noisy(k, ideal, t, counts, jp))
    got = spad_noisy_transients(KEY, ideal, t, counts,
                                SpadParams(num_photons=2000, pileup=False),
                                device="cpu").numpy()
    _same_distribution(got, want, ideal, 2000)


def test_runner_calibration_bins():
    """The synthetic calibration rounds to 184 jitter bins in [-21, 162]
    at 4 ps, as in the JAX package."""
    t, _ = prun._find_jitter_calibration("/nonexistent")
    js = torch.tensor(t, dtype=torch.float32)
    b = torch.round(js / torch.tensor(4e-12, dtype=torch.float32))
    with jax.enable_x64(False):
        want = np.asarray(jax.numpy.round(jax.numpy.asarray(t) / 4e-12))
    np.testing.assert_array_equal(b.numpy(), want)
    assert len(set(b.tolist())) == 184 and b.min() == -21 and b.max() == 162


@pytest.mark.parametrize("pileup", [False, True])
def test_chunk_invariance(pileup):
    """One key a point: any chunk of points gives the same counts."""
    t, counts = jrun._find_jitter_calibration("/nonexistent")
    rng = np.random.RandomState(1)
    ideal = rng.rand(7, 300) * (np.arange(300) > 120)
    params = SpadParams(num_photons=300, pileup=pileup, mu_noise=50.0)
    outs = [spad_noisy_transients(KEY, ideal, t, counts, params,
                                  source_chunk=c, device="cpu")
            for c in (1, 3, 16)]
    assert outs[0].abs().sum() > 0
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    # and a point alone, from its own key, gives its row
    raw = spad_noisy_transients(KEY, ideal, t, counts, params, rescale=False,
                                device="cpu")
    one = spad_model(sampling.split(KEY, 7)[3], ideal[3], t, counts, params,
                     device="cpu")
    assert torch.equal(one, raw[3])


@pytest.mark.parametrize("pileup", [False, True])
def test_zero_row_gives_zeros(pileup):
    ideal = np.stack([_ideal(), np.zeros(200), -_ideal()])
    params = SpadParams(num_photons=400, pileup=pileup)
    out = spad_noisy_transients(KEY, ideal, *NO_JITTER, params,
                                device="cpu").numpy()
    assert np.isfinite(out).all()
    assert out[0].sum() > 0 and not out[1].any()
    raw = spad_noisy_transients(KEY, ideal, *NO_JITTER, params,
                                rescale=False, device="cpu").numpy()
    # no light, no photon: only the background, mean mu_noise * M / 1 *
    # B / 1 = 8e8 a bin, is left
    assert np.isfinite(raw).all()
    for row in raw[1:]:
        assert abs(row.mean() / 8e8 - 1) < 1e-4


@pytest.mark.parametrize("pileup", [False, True])
def test_afterpulses_match_jax(pileup):
    """A hold-off of 10 bins and app 0.5: afterpulses land in range; the
    afterpulse uniforms are JAX's bit for bit, so the counts follow."""
    params = dict(num_photons=1500, mu_noise=0.0, app=0.5, pileup=pileup,
                  t_hold_off=40e-12)
    got = _model(_ideal(), *NO_JITTER, SpadParams(**params))
    want = _jax(lambda k: jspad_model(k, _ideal(), *NO_JITTER,
                                      JParams(**params)))
    base = _model(_ideal(), *NO_JITTER, SpadParams(**{**params, "app": 0.0}))
    assert got.sum() > base.sum()
    assert abs(got.sum() - want.sum()) <= 0.01 * want.sum()
    # afterpulses sit HO = 10 bins after their photon
    assert got[90:100].sum() > base[90:100].sum()
