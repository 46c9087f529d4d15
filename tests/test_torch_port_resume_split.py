"""The ``split_local`` layout's resume on the CPU, on each wire.

``none``, ``int8`` and ``topk8``: one epoch and a resumed one give the
two-epoch run bit for bit, and track JAX's CLI from JAX's init within
1e-4 (1e-3 on ``int8``/``topk8``); helpers and the small seeded
datasets of tests/test_torch_port_resume.py. On ``topk8`` both ledgers
matter: without the client's up-direction ledger (in its checkpoint),
or without the server's sidecar, the resumed series is another one.
"""

import os

import pytest

from split_learning_tpu_torch.runtime import client as client_mod

from test_torch_port_resume import (
    LAYOUTS, assert_resume_is_uninterrupted, assert_resume_tracks_jax, port)

SPLIT = ("split_none", "split_int8", "split_topk8")


@pytest.mark.parametrize("layout", SPLIT)
def test_resume_is_the_uninterrupted_run(layout, tmp_path):
    assert_resume_is_uninterrupted(tmp_path, layout)


@pytest.mark.parametrize("layout", SPLIT)
def test_resume_tracks_jax(layout, tmp_path):
    assert_resume_tracks_jax(tmp_path, layout)


@pytest.mark.parametrize("drop", ["client_ledger", "server_sidecar"])
def test_topk8_resume_needs_both_ledgers(drop, tmp_path, monkeypatch):
    flags = LAYOUTS["split_topk8"][0]
    whole = port(tmp_path / "a", flags, "--epochs", "2")
    ck = tmp_path / "ck"
    first = port(tmp_path / "b", flags, "--epochs", "1",
                 "--checkpoint-dir", str(ck))
    if drop == "server_sidecar":
        for name in os.listdir(ck):
            if name.startswith("extras-"):
                os.remove(ck / name)
    else:
        monkeypatch.setattr(client_mod, "_restore_ledger",
                            lambda transport, records: None)
    second = port(tmp_path / "b", flags, "--epochs", "1",
                  "--checkpoint-dir", str(ck), "--resume")
    assert first == whole[:len(first)]
    assert second != whole[len(first):]
