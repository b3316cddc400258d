"""Crash-atomic checkpoint rounds of the PyTorch port (train/checkpoint.py).

The counterparts of tests/test_ckpt_atomicity.py: a save stages its round
under ``rounds/.tmp-N`` and commits it with atomic renames, so a SIGKILL at
any point must leave a log directory that restores, with encoder, decoder and
optimizer all from the SAME round. The kill sweep drives a real subprocess
(tests/torch_ckpt_kill_victim.py) through injected crash windows
(TCVAE_CKPT_TEST_PAUSE) and SIGKILLs it inside each. The doctor's report on a
rounds layout (``test_doctor_reports_round_state`` there) waits for the port
of ``tools/validate_logdir``."""

import os
import select
import shutil
import signal
import subprocess
import sys
import time

import pytest
import torch

from torch_port_helpers import tiny_config
from trustedai_cl_vae_ad_tpu_torch.ops import quant
from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_config
from trustedai_cl_vae_ad_tpu_torch.train import checkpoint
from trustedai_cl_vae_ad_tpu_torch.train.checkpoint import (
    ROUNDS_SUBDIR,
    AsyncSaver,
    resolve_round_dir,
    restore_optimizer_state,
    restore_params,
    save_checkpoint,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VICTIM = os.path.join(REPO, "tests", "torch_ckpt_kill_victim.py")
SUBTREES = ("encoder", "decoder", "optimizer")


def _tree(v, n=8):
    return {"encoder.w": torch.full((n, n), float(v)), "decoder.w": torch.full((n, n), float(v))}


def _opt(v):
    return {"count": int(v), "mu": _tree(v), "nu": _tree(v)}


def _values(d):
    """(encoder, decoder, optimizer mu, optimizer count) as restored from d."""
    params, opt = restore_params(d), restore_optimizer_state(d)
    return (float(params["encoder.w"][0, 0]), float(params["decoder.w"][0, 0]),
            float(opt["mu"]["encoder.w"][0, 0]), opt["count"])


def _rounds(d):
    return sorted(n for n in os.listdir(os.path.join(d, ROUNDS_SUBDIR)) if not n.startswith("."))


def _write_flat(d, v):
    """A log directory as this package wrote it before the rounds layout: real
    ``encoder/``, ``decoder/``, ``optimizer/`` directories, one file each."""
    trees = checkpoint._subtrees(_tree(v), _opt(v))
    for sub, tensors in trees.items():
        os.makedirs(os.path.join(d, sub))
        torch.save(tensors, os.path.join(d, sub, checkpoint._payload_file(sub)))


def test_round_layout_symlinks_and_gc(tmp_path):
    """Saves create complete rounds; the stable paths become symlinks; only
    the last two rounds are kept; restoring reads the newest."""
    d = str(tmp_path / "log")
    for v in (1.0, 2.0, 3.0):
        save_checkpoint(d, _tree(v), opt_state=_opt(v))
    assert _rounds(d) == ["00000002", "00000003"]
    for sub in SUBTREES:
        p = os.path.join(d, sub)
        assert os.path.islink(p) and os.path.isdir(p)  # the stable path resolves
    assert os.path.islink(os.path.join(d, "current"))
    assert os.readlink(os.path.join(d, "current")) == os.path.join(ROUNDS_SUBDIR, "00000003")
    assert os.path.isfile(os.path.join(d, "encoder", "params.pt"))
    assert os.path.isfile(os.path.join(d, "optimizer", "state.pt"))
    assert _values(d) == (3.0, 3.0, 3.0, 3)
    assert checkpoint.has_optimizer(d)


def test_keep_rounds_knob(tmp_path, monkeypatch):
    """TCVAE_CKPT_KEEP_ROUNDS=1: only the newest round survives each commit;
    restoring still works (rounds are deleted after the commit only)."""
    monkeypatch.setenv("TCVAE_CKPT_KEEP_ROUNDS", "1")
    d = str(tmp_path / "log")
    for v in (1.0, 2.0, 3.0):
        save_checkpoint(d, _tree(v), opt_state=_opt(v))
    assert _rounds(d) == ["00000003"]
    assert _values(d)[0] == 3.0
    monkeypatch.setenv("TCVAE_CKPT_KEEP_ROUNDS", "0")  # never below one
    save_checkpoint(d, _tree(4.0), opt_state=_opt(4.0))
    assert _rounds(d) == ["00000004"] and _values(d)[0] == 4.0


def test_legacy_inplace_logdir_restores_and_upgrades(tmp_path):
    """A flat log directory (real encoder/ decoder/ optimizer/ directories, as
    earlier versions wrote) still restores; the first new save upgrades it to
    the round layout with no window in which neither copy exists."""
    d = str(tmp_path / "legacy")
    _write_flat(d, 7.0)
    assert resolve_round_dir(d) == d
    assert _values(d) == (7.0, 7.0, 7.0, 7) and checkpoint.has_optimizer(d)

    save_checkpoint(d, _tree(8.0), opt_state=_opt(8.0))
    for sub in SUBTREES:
        assert os.path.islink(os.path.join(d, sub))  # upgraded
    assert _values(d) == (8.0, 8.0, 8.0, 8)


def test_legacy_copy_survives_a_kill_before_the_upgrade_commits(tmp_path, monkeypatch):
    """The upgrade removes the flat copy only after the round is durable and
    pointed at: a save that dies while staging leaves the flat copy, a save
    that dies right after the pointer swap leaves the round."""
    d = str(tmp_path / "legacy")
    _write_flat(d, 7.0)

    def die(*_a, **_k):
        raise KeyboardInterrupt

    monkeypatch.setattr(checkpoint, "_commit_round", die)
    with pytest.raises(KeyboardInterrupt):
        save_checkpoint(d, _tree(8.0), opt_state=_opt(8.0))
    monkeypatch.undo()
    assert os.path.isdir(os.path.join(d, ROUNDS_SUBDIR, ".tmp-00000001"))
    assert resolve_round_dir(d) == d and _values(d) == (7.0, 7.0, 7.0, 7)

    symlink = checkpoint._atomic_symlink

    def die_after_pointer(target, link_path):
        symlink(target, link_path)
        if os.path.basename(link_path) == "current":
            raise KeyboardInterrupt

    monkeypatch.setattr(checkpoint, "_atomic_symlink", die_after_pointer)
    with pytest.raises(KeyboardInterrupt):
        save_checkpoint(d, _tree(9.0), opt_state=_opt(9.0))
    monkeypatch.undo()
    assert not os.path.islink(os.path.join(d, "encoder"))  # the flat copy is still there
    assert _values(d) == (9.0, 9.0, 9.0, 9)               # but the round is what restores
    save_checkpoint(d, _tree(10.0), opt_state=_opt(10.0))
    assert os.path.islink(os.path.join(d, "encoder")) and _values(d)[0] == 10.0


def test_symlink_following_copy_still_saves(tmp_path):
    """A log directory copied WITHOUT keeping symlinks (cp -r, rsync without
    -l, shutil.copytree's default) has current/ and the stable paths as real
    directories: restoring and further saves must still work."""
    src = str(tmp_path / "src")
    save_checkpoint(src, _tree(1.0), opt_state=_opt(1.0))
    dst = str(tmp_path / "copy")
    shutil.copytree(src, dst)  # follows symlinks: current/ becomes a real directory
    assert not os.path.islink(os.path.join(dst, "current"))
    assert _values(dst) == (1.0, 1.0, 1.0, 1)
    save_checkpoint(dst, _tree(2.0), opt_state=_opt(2.0))
    assert _values(dst) == (2.0, 2.0, 2.0, 2)
    assert os.path.islink(os.path.join(dst, "current"))
    assert all(os.path.islink(os.path.join(dst, sub)) for sub in SUBTREES)


def test_no_stable_name_dangles_when_a_round_has_no_optimizer(tmp_path):
    """A save without the moments publishes no ``optimizer`` name (a dangling
    symlink breaks ``shutil.copytree`` and anything that walks the directory);
    the name appears with the first round that holds moments and goes again
    with the next that does not."""
    d = str(tmp_path / "log")
    save_checkpoint(d, _tree(1.0))
    assert not os.path.lexists(os.path.join(d, "optimizer")) and not checkpoint.has_optimizer(d)
    shutil.copytree(d, str(tmp_path / "copy1"))
    save_checkpoint(d, _tree(2.0), opt_state=_opt(2.0))
    assert os.path.islink(os.path.join(d, "optimizer")) and checkpoint.has_optimizer(d)
    save_checkpoint(d, _tree(3.0))
    assert not os.path.lexists(os.path.join(d, "optimizer")) and not checkpoint.has_optimizer(d)
    for root, _dirs, files in os.walk(d):
        assert all(os.path.exists(os.path.join(root, f)) for f in files), root
    shutil.copytree(d, str(tmp_path / "copy3"))
    assert float(restore_params(str(tmp_path / "copy3"))["encoder.w"][0, 0]) == 3.0
    # a flat directory with moments, superseded by a round without: its copy goes too
    flat = str(tmp_path / "flat")
    _write_flat(flat, 7.0)
    save_checkpoint(flat, _tree(8.0))
    assert not os.path.lexists(os.path.join(flat, "optimizer"))
    assert float(restore_params(flat)["decoder.w"][0, 0]) == 8.0


def _run_victim_until(d, point, marker):
    """Start the victim, wait for ``marker`` on its output, SIGKILL it. The
    pipe is read with ``os.read``: a buffered ``readline`` can pull two lines
    out of the pipe at once, after which ``select`` sees an empty pipe and the
    marker would sit unread until the victim's pause is over."""
    proc = subprocess.Popen([sys.executable, VICTIM, d, point], cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        fd = proc.stdout.fileno()
        deadline = time.time() + 120
        buf = ""
        while marker not in buf:
            if time.time() > deadline:
                pytest.fail(f"timed out waiting for {marker}:\n{buf}")
            ready, _, _ = select.select([fd], [], [], 1.0)
            if not ready:
                if proc.poll() is not None:
                    pytest.fail(f"victim exited before {marker}:\n{buf}")
                continue
            chunk = os.read(fd, 65536)
            if not chunk:
                pytest.fail(f"victim EOF before {marker}:\n{buf}")
            buf += chunk.decode(errors="replace")
        assert "ROUND1-DONE" in buf, buf
        assert proc.poll() is None, f"the victim was gone before it could be killed:\n{buf}"
        os.kill(proc.pid, signal.SIGKILL)  # what the out-of-memory killer does
        proc.wait(timeout=30)
        assert "ROUND2-DONE" not in buf
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()


# The round that must survive a kill in each window: the pointer swap is the
# commit point, so a kill before it restores round 1, after it round 2.
_KILL_POINTS = [
    ("between_subtrees", 1.0),  # round 2's encoder staged, its decoder not
    ("before_commit", 1.0),     # round 2 fully staged, not renamed
    ("mid_commit", 1.0),        # round 2 durable, the pointer still at round 1
    ("after_pointer", 2.0),     # the pointer at round 2, housekeeping unfinished
]


@pytest.mark.parametrize("point,expected", _KILL_POINTS, ids=[p for p, _ in _KILL_POINTS])
def test_sigkill_during_save_restores_consistent_round(tmp_path, point, expected):
    d = str(tmp_path / "log")
    _run_victim_until(d, point, f"CKPT-PAUSE:{point}")
    # the directory restores, and ALL THREE subtrees come from one round: a
    # torn mix (encoder N, decoder N-1) would load without error
    enc, dec, mu, count = _values(d)
    assert enc == dec == mu == count == expected, (point, enc, dec, mu, count)
    # the sidecar's provenance stamp reads the round that restoring reads
    stamp = quant.float_checkpoint_stamp(d)
    in_round = quant.float_checkpoint_stamp(resolve_round_dir(d))
    assert stamp == in_round and all(stamp.values())
    # the directory stays writable: the next save sweeps stale staging and
    # commits a new round on top
    save_checkpoint(d, _tree(3.0), opt_state=_opt(3.0))
    assert _values(d) == (3.0, 3.0, 3.0, 3)
    assert not [n for n in os.listdir(os.path.join(d, ROUNDS_SUBDIR)) if n.startswith(".")]


def test_sigkill_during_async_background_write(tmp_path):
    """AsyncSaver: a kill while the background write is in flight leaves
    round 1 as the restore point: an uncommitted round (wait() never ran) is
    never selected, whether or not its bytes finished landing."""
    d = str(tmp_path / "log")
    _run_victim_until(d, "async_inflight", "ASYNC-STARTED")
    assert _values(d) == (1.0, 1.0, 1.0, 1)
    assert _rounds(d) == ["00000001"]


def test_failed_async_round_never_commits_and_drops_sidecar(tmp_path, monkeypatch):
    """A failed background write drops that round's commit callbacks (a later
    wait() or close() must not fire them) and the round never commits; the
    next save still works, from fresh staging."""
    d = str(tmp_path / "log")
    saver = AsyncSaver()
    commits = []
    try:
        saver.save(d, _tree(0.0))
        saver.add_commit_callback(lambda: commits.append(1))
        saver.wait()
        assert commits == [1]

        write = checkpoint._write_payload

        def fail_on_decoder(obj, staging, sub):
            if sub == "decoder":
                raise OSError("disk full")
            write(obj, staging, sub)

        monkeypatch.setattr(checkpoint, "_write_payload", fail_on_decoder)
        saver.save(d, _tree(1.0))
        saver.add_commit_callback(lambda: commits.append(2))
        with pytest.raises(OSError, match="disk full"):
            saver.wait()
        monkeypatch.undo()
        # the failed round's callback is gone for good; round 1 is still the
        # newest complete round
        saver.wait()
        assert commits == [1]
        assert float(restore_params(d)["encoder.w"][0, 0]) == 0.0 and _rounds(d) == ["00000001"]

        saver.save(d, _tree(3.0))
        saver.add_commit_callback(lambda: commits.append(3))
        saver.wait()
        assert commits == [1, 3]
    finally:
        saver.close()
    assert float(restore_params(d)["encoder.w"][0, 0]) == 3.0
    assert _rounds(d) == ["00000001", "00000002"]  # the failed staging was swept, its number reused


def test_async_save_holds_the_state_at_save_not_after_later_steps(tmp_path):
    """``Adam.step`` updates parameters and moments in place: what a round
    holds is the state when ``save`` returned, and only ``wait`` commits it,
    with one round in flight at most."""
    d = str(tmp_path / "log")
    params, opt = _tree(1.0), _opt(1.0)
    saver = AsyncSaver()
    saver.save(d, params, opt_state=opt)
    for t in (*params.values(), *opt["mu"].values(), *opt["nu"].values()):
        t.add_(41.0)  # the training step that follows the save
    assert resolve_round_dir(d) == os.path.abspath(d)  # nothing committed yet
    saver.save(d, params, opt_state={**opt, "count": 2})  # waits out and commits round 1
    assert _values(d) == (1.0, 1.0, 1.0, 1)
    saver.close()
    assert _values(d) == (42.0, 42.0, 42.0, 2)
    assert _rounds(d) == ["00000001", "00000002"]
    saver.close()  # closing twice is harmless


def test_sidecar_stamp_holds_across_a_round_commit(tmp_path):
    """The quantized sidecar's provenance stamp follows the CONTENT of the
    float checkpoint through the rounds: it still matches after the same
    weights were committed into a new round, after a kill between a round's
    rename and the pointer swap, and stops matching after a retrain."""
    cfg = tiny_config(image=(16, 16, 3), layers=(4,), latent=8)
    model = load_model_from_config(cfg, seed=0, device="cpu")
    d = str(tmp_path / "log")
    model.save_model(d, include_optimizer=False)
    quant.save_quantized_checkpoint(d, quant.quantize_params(model.core, model.params, 0))
    assert quant.quantized_staleness(d) is None
    first = quant.float_checkpoint_stamp(d)
    assert all(first.values()) and not checkpoint.has_optimizer(d)

    model.save_model(d, include_optimizer=False)  # the same weights, round 2
    assert _rounds(d) == ["00000001", "00000002"]
    assert quant.float_checkpoint_stamp(d) == first and quant.quantized_staleness(d) is None

    # a retrain killed between the rename of round 3 and the swap of current:
    # restoring still reads round 2, and so does the stamp
    other = load_model_from_config(cfg, seed=1, device="cpu")
    trees = checkpoint._subtrees(other.params, None)
    staging, n = checkpoint._stage_round(d)
    for sub, tensors in trees.items():
        checkpoint._write_payload(tensors, staging, sub)
    os.rename(staging, os.path.join(d, ROUNDS_SUBDIR, checkpoint._round_name(n)))
    assert resolve_round_dir(d).endswith("00000002")
    assert quant.float_checkpoint_stamp(d) == first and quant.quantized_staleness(d) is None

    other.save_model(d, include_optimizer=False)  # the retrain, committed
    assert quant.float_checkpoint_stamp(d) != first
    assert quant.quantized_staleness(d)[0] == "provenance_mismatch"
