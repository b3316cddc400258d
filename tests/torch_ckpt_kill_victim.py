"""Subprocess victim of the kill-during-save sweep of the PyTorch port
(tests/test_torch_ckpt_atomicity.py). Writes round 1 (every value 1.0)
normally, then starts round 2 (every value 2.0) with a TCVAE_CKPT_TEST_PAUSE
crash window at the pause point given in argv; the parent SIGKILLs this
process the moment the pause marker prints. Not a pytest module (no test_
prefix)."""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402


def tree(v: float, n: int = 8) -> dict:
    return {"encoder.w": torch.full((n, n), v), "decoder.w": torch.full((n, n), v)}


def opt(v: float) -> dict:
    return {"count": int(v), "mu": tree(v), "nu": tree(v)}


def main() -> None:
    log_dir, pause_point = sys.argv[1], sys.argv[2]
    from trustedai_cl_vae_ad_tpu_torch.train.checkpoint import AsyncSaver, save_checkpoint

    save_checkpoint(log_dir, tree(1.0), opt_state=opt(1.0))
    print("ROUND1-DONE", flush=True)
    if pause_point == "async_inflight":
        # round 2 through the background writer, killed before wait() ever
        # commits it: bulky tensors keep the write going while the parent
        # kills this process, but the assertion holds whether or not the
        # write completed, because an uncommitted round is never selected
        saver = AsyncSaver()
        saver.save(log_dir, tree(2.0, n=2048), opt_state=opt(2.0))
        print("ASYNC-STARTED", flush=True)
        time.sleep(30)  # the parent SIGKILLs here
        return
    os.environ["TCVAE_CKPT_TEST_PAUSE"] = f"{pause_point}:30"
    save_checkpoint(log_dir, tree(2.0), opt_state=opt(2.0))
    print("ROUND2-DONE", flush=True)


if __name__ == "__main__":
    main()
