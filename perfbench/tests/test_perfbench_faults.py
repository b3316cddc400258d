"""A run with the timed path broken underneath it comes out not correct: once for each
fault the cells can have (one chip: no exchange between chips to leave out). The
harness's look for a chip is skipped; the rest of a run goes as on the card, at a tiny
size on the CPU, held to the real cells' limits."""

import pytest
import torch

from perfbench import harness


def _run(root, cell):
    return harness.run_cell(harness.load_cell(root, cell), 2 ** 35 + 11, 0.2, False, "cpu", 0.0)


def test_sound_runs_are_correct(tiny_root):
    assert _run(tiny_root, "tiny-train")["correct"]
    assert _run(tiny_root, "tiny-fleet")["correct"]


def test_train_step_that_leaves_the_state_unchanged(tiny_root, monkeypatch):
    from trustedai_cl_vae_ad_tpu_torch.ops.adam import Adam

    monkeypatch.setattr(Adam, "step", lambda self, grads=None: None)
    out = _run(tiny_root, "tiny-train")
    assert not out["correct"]
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)



def test_train_update_of_the_wrong_sign(tiny_root, monkeypatch):
    """Adam's update applied backwards keeps every leaf's norms (grad_gap, change_gap):
    the losses of the later checked steps catch it."""
    from trustedai_cl_vae_ad_tpu_torch.ops.adam import Adam

    real = Adam.step

    def backwards(self, grads=None):
        before = [p.detach().clone() for p in self.params]
        real(self, grads)
        with torch.no_grad():
            for p, p0 in zip(self.params, before):
                p.copy_(2 * p0 - p)

    monkeypatch.setattr(Adam, "step", backwards)
    out = _run(tiny_root, "tiny-train")
    assert not out["correct"]
    assert out["checks"]["loss_gap"]["value"] > out["checks"]["loss_gap"]["limit"]

def test_train_step_on_half_the_batch(tiny_root, monkeypatch):
    from trustedai_cl_vae_ad_tpu_torch.models.wrapper import VAEModel

    full = VAEModel.train_step
    monkeypatch.setattr(VAEModel, "train_step", lambda self, x, eps=None: full(
        self, x[:x.shape[0] // 2], eps=None if eps is None else eps[:eps.shape[0] // 2]))
    assert not _run(tiny_root, "tiny-train")["correct"]


def test_train_loss_altered_where_it_is_produced(tiny_root, monkeypatch):
    from trustedai_cl_vae_ad_tpu_torch.models.kurtosis_global import KurtosisGlobalCVAE

    real = KurtosisGlobalCVAE.compute_loss

    def altered(self, *args, **kwargs):
        out = real(self, *args, **kwargs)
        d = out[0] if isinstance(out, tuple) else out
        d["loss"] = d["loss"] * 1.01
        return out

    monkeypatch.setattr(KurtosisGlobalCVAE, "compute_loss", altered)
    assert not _run(tiny_root, "tiny-train")["correct"]


def _patch_scorer(monkeypatch, change):
    from trustedai_cl_vae_ad_tpu_torch.ops import stream_score

    real = stream_score.stream_score_step_batched
    monkeypatch.setattr(stream_score, "stream_score_step_batched",
                        lambda maps, scalars, *a: change(maps, scalars, real(maps, scalars, *a)))


def test_fleet_tick_that_leaves_the_state_unchanged(tiny_root, monkeypatch):
    _patch_scorer(monkeypatch, lambda maps, scalars, out: (maps, scalars) + tuple(out[2:]))
    assert not _run(tiny_root, "tiny-fleet")["correct"]


def test_fleet_tick_with_half_the_frames_left_out(tiny_root, monkeypatch):
    from trustedai_cl_vae_ad_tpu_torch.stream.multicam import MultiCameraEngine

    real = MultiCameraEngine._block_forward

    def half(self, j, x):
        h = (x.shape[0] + 1) // 2
        rec = real(self, j, x[:h])
        return torch.cat([rec, rec[:x.shape[0] - h]])  # the rest take the first half's

    monkeypatch.setattr(MultiCameraEngine, "_block_forward", half)
    assert not _run(tiny_root, "tiny-fleet")["correct"]


def test_fleet_answer_altered_where_it_is_produced(tiny_root, monkeypatch):
    calls = []

    def one_score_off(maps, scalars, out):
        calls.append(1)
        if len(calls) == 3:  # one stream's score in one tick, off by one
            out[3][0, 0] += 1.0
        return out

    _patch_scorer(monkeypatch, one_score_off)
    out = _run(tiny_root, "tiny-fleet")
    assert not out["correct"]
    assert out["checks"]["score_gap"]["value"] == pytest.approx(1.0, abs=1e-5)
