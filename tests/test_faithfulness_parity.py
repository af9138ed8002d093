"""Faithfulness sweep parity: our on-device mask builder reproduces the
reference's numpy xor-loop semantics exactly (same ranking, stops and base).

The reference module can't be imported here (it pulls torchvision, absent in
this image), so its mask construction — rank players by attribution
descending, linspace stops, xor the top-i players against the base
(/root/reference/scripts/measure_faithfulness.py:225-251) — is restated
inline as the oracle."""

import jax.numpy as jnp
import numpy as np

from autognothi.pipeline.measure_faithfulness import _auc, perturbation_masks


def _reference_masks(attr: np.ndarray, n_players: int, steps: int, base: int):
    steps = min(n_players, steps)
    ranking = np.argsort(attr)[::-1]
    stops = np.linspace(0, n_players, steps, dtype=np.int64)
    masks = []
    for i in stops:
        mask = np.ones((n_players,), dtype=np.int64) * base
        mask[ranking[:i]] ^= 1
        masks.append(mask)
    return stops, np.stack(masks)


def test_masks_match_reference_builder():
    rng = np.random.RandomState(0)
    n_players, steps = 12, 7
    attr = rng.randn(n_players).astype(np.float32)

    stops_np = np.linspace(0, n_players, steps, dtype=np.int64)
    for base in (0, 1):
        ref_stops, ref_masks = _reference_masks(attr, n_players, steps, base)
        np.testing.assert_array_equal(ref_stops, stops_np)
        ours = perturbation_masks(
            jnp.asarray(attr)[None, :], jnp.asarray(stops_np), base
        )  # <1, S, P>
        np.testing.assert_array_equal(np.asarray(ours)[0], ref_masks)


def test_auc_matches_reference_trapezoid():
    # reference _auc: mean of midpoints of consecutive values
    # (measure_faithfulness.py:143-146)
    rng = np.random.RandomState(1)
    curve = {int(s): float(v) for s, v in zip(range(0, 12, 2), rng.rand(6))}
    vals = np.array(list(curve.values()))
    want = float(((vals[1:] + vals[:-1]) / 2).mean())
    assert _auc(curve) == want
