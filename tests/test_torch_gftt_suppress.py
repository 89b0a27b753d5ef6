"""The port's GFTT device suppression route (plain torch on the CPU, the
CPU arm of K4's wrapper) against the JAX package's and against the port's
own host route.

- The fixed point: ``gftt.suppress_plain`` against the reference's
  ``_suppress_device`` on the same quality maps (noise, all-equal
  qualities, quantized qualities; d ∈ {1, 2.5, 5, 8}; the round cap hit,
  and a fixed point cut by the cap and resumed from its state): the kept
  maps equal to the bit, ``converged`` equal.  Both only compare qualities
  and indices, so no tolerance applies.
- The route end to end (``gftt_dispatch`` + ``gftt_finish``) on
  test_gftt.py's synthetic images: the corners equal the JAX device
  route's and the port's host route's, exactly and in the same order; the
  qualities equal the host route's and lie within rtol 1e-5 of JAX's (the
  response maps' tolerance in test_torch_gftt.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polychase_tpu.engine import gftt as JG

from polychase_tpu_torch import convert, native
from polychase_tpu_torch.engine import gftt as TG
from polychase_tpu_torch.kernels import gftt_suppress

from test_gftt import synth_image

torch.set_num_threads(1)

CPU = torch.device("cpu")
DISCS = (1.0, 2.5, 5.0, 8.0)


def _host_route(monkeypatch, *args, **kw):
    """One frame's GFTT on the host route: the device route's threshold
    set above any frame."""
    with monkeypatch.context() as m:
        m.setattr(TG, "DEVICE_SUPPRESS_MIN", 1 << 62)
        return TG.gftt_finish(TG.gftt_dispatch(*args, **kw))


def _qmap(rng, kind, shape=(48, 64)):
    q = rng.random(shape).astype(np.float32)
    q[rng.random(shape) < 0.6] = 0.0
    if kind == "ties":
        q = np.where(q > 0, np.float32(0.5), np.float32(0.0))
    elif kind == "quantized":
        q = np.round(q * 4).astype(np.float32) / 4
    return q


@pytest.mark.parametrize("d", DISCS + (3.3,))
def test_circle_offsets_match_jax(d):
    assert TG._circle_offsets(d) == JG._circle_offsets(d)


@pytest.mark.parametrize("kind", ["noise", "ties", "quantized"])
@pytest.mark.parametrize("d", DISCS)
def test_suppress_matches_jax(kind, d):
    rng = np.random.default_rng(int(d * 10) + len(kind))
    q = _qmap(rng, kind)
    offs = TG._circle_offsets(d)
    jk, jc = JG._suppress_device(jnp.asarray(q), offsets=offs)
    before = gftt_suppress.launches
    kept, conv, rounds, _ = gftt_suppress.gftt_suppress(torch.as_tensor(q),
                                                        offs)
    assert gftt_suppress.launches == before  # CPU tensors: the plain version
    np.testing.assert_array_equal(kept.numpy(), np.asarray(jk))
    assert bool(conv) == bool(jc) is True
    assert 1 <= int(rounds) <= TG.MAX_ROUNDS
    assert kept.sum() > 0


@pytest.mark.parametrize("d", [2.5, 5.0])
def test_round_cap_matches_jax(d):
    """Stopped after 2 rounds, with points still undecided: the same
    partial kept map and ``converged`` False in both."""
    q = _qmap(np.random.default_rng(7), "ties")
    offs = TG._circle_offsets(d)
    jk, jc = JG._suppress_device(jnp.asarray(q), offsets=offs, max_rounds=2)
    kept, conv, rounds, _ = TG.suppress_plain(torch.as_tensor(q), offs, 2)
    np.testing.assert_array_equal(kept.numpy(), np.asarray(jk))
    assert not bool(jc) and not bool(conv) and int(rounds) == 2


@pytest.mark.parametrize("cut", [1, 2, 5])
@pytest.mark.parametrize("d", [2.5, 5.0])
def test_resumed_fixed_point_matches_jax(cut, d):
    """Cut after ``cut`` rounds and resumed from its state, in batches of
    ``cut`` rounds, until it converges: the uncut reference's kept map, and
    as many rounds in all."""
    q = _qmap(np.random.default_rng(11), "ties")
    offs = TG._circle_offsets(d)
    jk, jc = JG._suppress_device(jnp.asarray(q), offsets=offs)
    qt = torch.as_tensor(q)
    _, _, want_rounds, _ = TG.suppress_plain(qt, offs)
    kept, conv, rounds, state = TG.suppress_plain(qt, offs, cut)
    total = int(rounds)
    assert not bool(conv)
    while not bool(conv):
        kept, conv, rounds, state = gftt_suppress.gftt_suppress(
            qt, offs, cut, state)
        total += int(rounds)
    np.testing.assert_array_equal(kept.numpy(), np.asarray(jk))
    assert bool(jc) and total == int(want_rounds)


def test_equal_qualities_keep_the_later_index():
    """Three equal qualities in a row within d of each other: the greedy
    pass visits the later row-major position first, so the last is kept
    and both others are rejected; a lone point further on is kept."""
    q = np.zeros((5, 12), np.float32)
    q[2, 2] = q[2, 3] = q[2, 4] = 1.0
    q[2, 10] = 1.0
    kept, conv, _, _ = TG.suppress_plain(torch.as_tensor(q),
                                         TG._circle_offsets(3.0))
    assert bool(conv)
    assert sorted(map(tuple, np.argwhere(kept.numpy()).tolist())) == [
        (2, 4), (2, 10)]


def test_quality_order_matches_lexsort():
    rng = np.random.default_rng(3)
    vals = rng.integers(1, 6, 4000).astype(np.float32)
    lin = rng.permutation(100_000)[:4000].astype(np.int64)
    np.testing.assert_array_equal(native.quality_order(vals, lin),
                                  np.lexsort((-lin, -vals)))


def test_route_guard(monkeypatch):
    monkeypatch.setattr(TG, "DEVICE_SUPPRESS_MIN", 1000)
    opts = TG.GFTTOptions
    assert TG.device_suppress_route(1000, opts(min_distance=5.0))
    assert not TG.device_suppress_route(999, opts(min_distance=5.0))
    assert TG.device_suppress_route(1000, opts(min_distance=1.0))
    assert TG.device_suppress_route(1000, opts(min_distance=8.0))
    assert not TG.device_suppress_route(1000, opts(min_distance=0.5))
    assert not TG.device_suppress_route(1000, opts(min_distance=8.5))


@pytest.mark.parametrize("opts", [
    JG.GFTTOptions(),
    JG.GFTTOptions(min_distance=2.5),
    JG.GFTTOptions(min_distance=8.0, max_corners=50),
    JG.GFTTOptions(use_harris=True, min_distance=1.0),
    JG.GFTTOptions(gradient_size=5, min_distance=3.0),
])
def test_device_route_matches_jax_and_host_route(rng, monkeypatch, opts):
    monkeypatch.setenv("POLYCHASE_GFTT_DEV_SUPPRESS_MIN", "0")
    monkeypatch.setattr(TG, "DEVICE_SUPPRESS_MIN", 0)
    img = synth_image(rng)
    ref_pts, ref_q = JG.good_features_to_track(img, None, opts)
    topts = convert.gftt_options(opts)
    disp = TG.gftt_dispatch(img, None, topts, device=CPU)
    assert disp.suppressed
    pts, q = TG.gftt_finish(disp)
    host_pts, host_q = _host_route(monkeypatch, img, None, topts, device=CPU)
    assert len(pts) > 40
    np.testing.assert_array_equal(pts, ref_pts)
    np.testing.assert_allclose(q, ref_q, rtol=1e-5)
    np.testing.assert_array_equal(pts, host_pts)
    np.testing.assert_array_equal(q, host_q)


def test_round_cap_resumes_on_the_device(rng, monkeypatch):
    """A fixed point cut at one round does not converge: the finish runs
    more rounds from its state on the device (the host route's corners)
    and counts the frame."""
    monkeypatch.setattr(TG, "DEVICE_SUPPRESS_MIN", 0)
    img = synth_image(rng)
    want = _host_route(monkeypatch, img, None, device=CPU)
    monkeypatch.setattr(TG, "MAX_ROUNDS", 1)
    before = TG.resumed_frames
    disp = TG.gftt_dispatch(img, None, device=CPU)
    assert disp.suppressed and not bool(disp.copy.numpy()[3])
    got = TG.gftt_finish(disp)
    assert TG.resumed_frames == before + 1
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_masked_frame_on_the_device_route(rng, monkeypatch):
    monkeypatch.setattr(TG, "DEVICE_SUPPRESS_MIN", 0)
    img = synth_image(rng)
    mask = np.zeros_like(img)
    mask[10:100, 20:140] = 255
    got = TG.good_features_to_track(img, mask, device=CPU)
    want = _host_route(monkeypatch, img, mask, device=CPU)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    p = got[0]
    assert len(p) > 10
    assert ((p[:, 0] >= 20) & (p[:, 0] < 140) & (p[:, 1] >= 10)
            & (p[:, 1] < 100)).all()


@pytest.mark.parametrize("kind", ["noise", "ties", "quantized"])
@pytest.mark.parametrize("d", [2.5, 5.0])
def test_suppress_kept_matches_jax(kind, d):
    """K4's compacting call on the CPU (the plain fixed point, then
    ``_compact_kept``): the JAX kept map's points in row-major order, their
    qualities, zero past the count; cut at k below the count, the first k
    of them with the full count."""
    rng = np.random.default_rng(int(d * 10) + 7 * len(kind))
    q = _qmap(rng, kind)
    offs = TG._circle_offsets(d)
    jk = np.asarray(JG._suppress_device(jnp.asarray(q), offsets=offs)[0])
    lin = np.flatnonzero(jk)
    for k in (q.size, len(lin) - 3):
        vals, idx, count, conv, rounds, state = (
            gftt_suppress.gftt_suppress_kept(torch.as_tensor(q), offs, k))
        assert bool(conv) and int(count) == len(lin)
        m = min(k, len(lin))
        np.testing.assert_array_equal(idx.numpy()[:m], lin[:m])
        np.testing.assert_array_equal(vals.numpy()[:m], q.reshape(-1)[lin[:m]])
        assert not vals.numpy()[m:].any() and not idx.numpy()[m:].any()
        np.testing.assert_array_equal(state.numpy() >= 2, jk)


@pytest.mark.parametrize("d", DISCS + (1.5, 3.3, 0.5))
def test_disc_rows_rebuild_the_disc(d):
    """K4 takes the disc as a half-width a row; the rows give back the
    offsets of ``_circle_offsets`` without (0, 0)."""
    offs = TG._circle_offsets(d)
    r, half = gftt_suppress.disc_rows(offs)
    rebuilt = {(dy, dx) for dy, h in zip(range(-r, r + 1), half)
               for dx in range(-h, h + 1)} - {(0, 0)}
    assert rebuilt == set(offs) - {(0, 0)}
    assert len(half) == 2 * r + 1


def test_disc_rows_refuse_other_shapes():
    with pytest.raises(ValueError):
        gftt_suppress.disc_rows(((0, 0), (0, 1), (1, 0)))


def test_kept_capacity_holds_the_kept_points():
    """The device route's buffer holds every kept point: above the hex
    packing count of the frame, at least 32,768, at most the frame."""
    assert TG.kept_capacity(1080, 1920, 5.0) == int(
        (1920 / 5 + 2) * (1080 / 5 + 2) * 1.16)
    assert TG.kept_capacity(48, 64, 5.0) == 48 * 64
    assert TG.kept_capacity(600, 800, 8.0) == 32768
    assert TG.kept_capacity(2160, 3840, 5.0) > 2 * 2160 * 3840 / (
        np.sqrt(3) * 25) + (2160 + 3840) / 5 + 1
