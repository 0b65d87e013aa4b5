"""The port's crash-recovery checkpoints (``repro_torch.checkpoint``), on
the CPU, mirroring the reference's ``tests/test_checkpoint.py``.

- ``store``: the tensor container round-trips trees, steps, metadata and
  dtypes (float64, int32, bf16, a generator's uint8 state); writes are
  atomic (a failed write leaves the previous checkpoint and no temp file);
  loading unpickles nothing but tensors and plain values.
- ``fl_state`` + ``FedSAEServer.run(checkpoint_dir=, resume=)``: a run
  killed at round t and resumed in a fresh server continues to the
  params, history state, residual, cohorts and records (all but
  ``wall_time_s``) of the uninterrupted run, bitwise, with faults and
  compression active, on MCLR and the MLP.
- ``fl_train --checkpoint-dir --resume --metrics-out``: the resumed JSONL
  holds the uninterrupted run's rounds, the trace cut back to the
  checkpoint first.
"""
import json
import os
import pickle

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import (latest_checkpoint, list_checkpoints,
                                    load_checkpoint, restore_server_state,
                                    save_checkpoint, save_server_state)
from repro_torch.core.server import FedSAEServer, ServerConfig
from repro_torch.data.federated import make_femnist_like
from repro_torch.faults import FaultModel
from repro_torch.launch import fl_train
from repro_torch.obs import read_jsonl
from torch_cases import one_torch_thread  # noqa: F401

DS_KW = dict(n_clients=24, total=1400, dim=16, max_size=60)


def _tree():
    return {"w": torch.arange(6.0).reshape(2, 3),
            "nested": {"b": torch.ones(4, dtype=torch.bfloat16),
                       "i": np.arange(3, dtype=np.int32)},
            "hist": np.linspace(0, 1, 5).astype(np.float64),
            "gen": torch.Generator().manual_seed(5).get_state()}


def _equal(a, b):
    return torch.equal(torch.as_tensor(a), torch.as_tensor(b))


def test_save_load_round_trip(tmp_path):
    path = str(tmp_path / "ckpt.pt")
    save_checkpoint(path, _tree(), step=17, metadata={"note": "hello",
                                                      "n": [1, 2]})
    tree, step, meta = load_checkpoint(path, like=_tree())
    assert step == 17 and meta == {"note": "hello", "n": [1, 2]}
    want = _tree()
    assert _equal(tree["w"], want["w"]) and _equal(tree["hist"],
                                                   want["hist"])
    assert _equal(tree["nested"]["b"], want["nested"]["b"])
    assert _equal(tree["nested"]["i"], want["nested"]["i"])
    assert _equal(tree["gen"], want["gen"])


def test_load_keeps_saved_dtypes(tmp_path):
    """float64 history and int32 counters come back as they were saved
    (the resume-bitwise linchpin), bf16 too, on the CPU."""
    path = str(tmp_path / "ckpt.pt")
    save_checkpoint(path, _tree())
    tree, _, _ = load_checkpoint(path, like=_tree())
    assert tree["hist"].dtype == torch.float64
    assert tree["nested"]["i"].dtype == torch.int32
    assert tree["nested"]["b"].dtype == torch.bfloat16
    assert tree["gen"].dtype == torch.uint8
    assert all(t.device.type == "cpu" for t in
               (tree["w"], tree["hist"], tree["nested"]["b"]))


def test_load_flat_without_like(tmp_path):
    path = str(tmp_path / "ckpt.pt")
    save_checkpoint(path, _tree(), step=3)
    flat, step, _ = load_checkpoint(path)
    assert step == 3
    assert set(flat) == {"w", "nested/b", "nested/i", "hist", "gen"}
    assert _equal(flat["nested/b"], torch.ones(4, dtype=torch.bfloat16))


def test_atomic_replace_over_existing(tmp_path):
    path = str(tmp_path / "ckpt.pt")
    save_checkpoint(path, {"x": np.zeros(2)}, step=1)
    save_checkpoint(path, {"x": np.ones(2)}, step=2)
    flat, step, _ = load_checkpoint(path)
    assert step == 2 and _equal(flat["x"], np.ones(2))
    assert os.listdir(tmp_path) == ["ckpt.pt"]


def test_failed_serialization_leaves_directory_untouched(tmp_path):
    path = str(tmp_path / "ckpt.pt")
    save_checkpoint(path, {"x": np.zeros(2)}, step=1)
    with pytest.raises(TypeError):
        # metadata that is not JSON fails before the temp file exists
        save_checkpoint(path, {"x": np.ones(2)}, step=2,
                        metadata={"bad": object()})
    flat, step, _ = load_checkpoint(path)
    assert step == 1 and _equal(flat["x"], np.zeros(2))
    assert os.listdir(tmp_path) == ["ckpt.pt"]


def test_failed_write_leaves_previous_checkpoint_and_no_temp(tmp_path,
                                                             monkeypatch):
    """A write that dies after the temp file is written (here: at its
    fsync) removes the temp file and leaves the old checkpoint whole."""
    path = str(tmp_path / "ckpt.pt")
    save_checkpoint(path, {"x": np.zeros(2)}, step=1)

    def boom(fd):
        raise OSError("disk gone")

    monkeypatch.setattr(os, "fsync", boom)
    with pytest.raises(OSError, match="disk gone"):
        save_checkpoint(path, {"x": np.ones(2)}, step=2)
    monkeypatch.undo()
    flat, step, _ = load_checkpoint(path)
    assert step == 1 and _equal(flat["x"], np.zeros(2))
    assert os.listdir(tmp_path) == ["ckpt.pt"]


class _Payload:
    def __reduce__(self):
        return (os.getcwd, ())


def test_load_unpickles_no_arbitrary_object(tmp_path):
    path = str(tmp_path / "evil.pt")
    with open(path, "wb") as f:
        torch.save({"step": 0, "metadata": "{}",
                    "tensors": {"x": _Payload()}}, f)
    with pytest.raises(pickle.UnpicklingError):
        load_checkpoint(path)


def test_missing_tensor_raises_keyerror(tmp_path):
    path = str(tmp_path / "ckpt.pt")
    save_checkpoint(path, {"x": np.zeros(2)})
    with pytest.raises(KeyError):
        load_checkpoint(path, like={"x": np.zeros(2), "y": np.zeros(2)})


def test_list_and_latest_checkpoints(tmp_path):
    d = str(tmp_path)
    assert list_checkpoints(d) == [] and latest_checkpoint(d) is None
    for t in (4, 2, 10):
        save_checkpoint(os.path.join(d, f"ckpt_{t:08d}.pt"),
                        {"x": np.zeros(1)}, step=t)
    (tmp_path / "not_a_ckpt.pt").write_bytes(b"")
    assert [r for r, _ in list_checkpoints(d)] == [2, 4, 10]
    assert latest_checkpoint(d).endswith("ckpt_00000010.pt")
    assert latest_checkpoint(str(tmp_path / "nope")) is None


# ---------------------------------------------------------------------------
# whole-server kill/resume, bitwise
# ---------------------------------------------------------------------------

CASES = {
    "mclr-shuffle": dict(sampling="shuffle"),
    "mclr-iid-faults": dict(
        sampling="iid", faults=FaultModel(
            seed=3, corrupt="nan", corrupt_prob=0.4, dropout_prob=0.2,
            availability="diurnal", day_rounds=4, straggler="pareto")),
    "mlp-topk_q8-faults": dict(
        sampling="iid", model="mlp", upload_compress="topk_q8",
        topk_frac=0.1,
        faults=FaultModel(seed=3, corrupt="explode", corrupt_prob=0.4)),
}


def _mk(**over):
    kw = dict(algo="ira", n_selected=8, rounds=8, h_cap=4.0,
              fixed_epochs=4.0, device="cpu")
    kw.update(over)
    return FedSAEServer(make_femnist_like(**DS_KW), cfg=ServerConfig(**kw))


def _assert_servers_bitwise(a, b):
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
    for name in ("L", "H", "theta"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
        assert getattr(b, name).dtype == np.float64
    np.testing.assert_array_equal(a.values.v, b.values.v)
    assert len(a.cohorts) == len(b.cohorts)
    for c1, c2 in zip(a.cohorts, b.cohorts):
        np.testing.assert_array_equal(c1, c2)
    if a.residual is not None:
        assert torch.equal(a.residual, b.residual)
    assert torch.equal(a.data_gen.get_state(), b.data_gen.get_state())


def _records(srv):
    out = []
    for r in srv._records.records:
        d = json.loads(r.to_json())
        d.pop("wall_time_s", None)
        out.append(d)
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_kill_and_resume_is_bitwise(tmp_path, case):
    full = _mk(**CASES[case])
    full.run()

    d = str(tmp_path / case)
    part = _mk(**CASES[case])
    part.run(rounds=4, checkpoint_dir=d, checkpoint_every=2)
    assert [r for r, _ in list_checkpoints(d)] == [2, 4]

    resumed = _mk(**CASES[case])           # a fresh server
    resumed.run(checkpoint_dir=d, checkpoint_every=2, resume=True)
    assert [r for r, _ in list_checkpoints(d)] == [2, 4, 6, 8]
    _assert_servers_bitwise(full, resumed)
    assert _records(full) == _records(resumed)
    if "faults" in CASES[case]:
        assert sum(r.screened for r in resumed._records.records) > 0


def test_checkpoint_dir_alone_saves_final_state(tmp_path):
    d = str(tmp_path / "final")
    srv = _mk(rounds=3)
    srv.run(checkpoint_dir=d)              # checkpoint_every=0
    assert [r for r, _ in list_checkpoints(d)] == [3]


def test_resume_guards(tmp_path):
    srv = _mk(rounds=2)
    with pytest.raises(ValueError, match="requires checkpoint_dir"):
        srv.run(resume=True)
    with pytest.raises(FileNotFoundError):
        srv.run(checkpoint_dir=str(tmp_path / "empty"), resume=True)


def test_save_restore_server_state_direct(tmp_path):
    """State-level round trip with no round in between, the quarantine
    counters and the generator state included."""
    d = str(tmp_path / "direct")
    srv = _mk(**CASES["mlp-topk_q8-faults"])
    srv.run(rounds=3)
    srv.q_fail[:3] = [1, 2, 3]
    save_server_state(srv, d, 3)
    fresh = _mk(**CASES["mlp-topk_q8-faults"])
    assert restore_server_state(fresh, d) == 3
    _assert_servers_bitwise(srv, fresh)
    assert fresh.q_fail.dtype == np.int32
    np.testing.assert_array_equal(fresh.q_fail, srv.q_fail)
    assert _records(srv) == _records(fresh)


def test_fl_train_resume_gives_the_uninterrupted_trace(tmp_path,
                                                      monkeypatch):
    """Kill after round 3 of 5, where the last checkpoint is round 2's:
    the resumed run cuts the trace back to rounds 0-1, appends 2-4, and
    the JSONL's rounds are the uninterrupted run's."""
    monkeypatch.chdir(tmp_path)
    flags = ["--device", "cpu", "--quiet", "--faults", "nan_upload",
             "--fault-prob", "0.3", "--compress", "topk_q8", "--model",
             "mlp", "--sampling", "iid"]
    fl_train.main(flags + ["--rounds", "5", "--metrics-out", "full.jsonl"])
    fl_train.main(flags + ["--rounds", "3", "--metrics-out", "cut.jsonl",
                           "--checkpoint-dir", "ck", "--checkpoint-every",
                           "2"])
    os.remove(os.path.join("ck", "ckpt_00000003.pt"))   # killed before it
    _, before = read_jsonl("cut.jsonl")
    assert [r.round for r in before] == [0, 1, 2]
    fl_train.main(flags + ["--rounds", "5", "--metrics-out", "cut.jsonl",
                           "--checkpoint-dir", "ck", "--resume"])
    meta_full, full = read_jsonl("full.jsonl")
    meta_cut, cut = read_jsonl("cut.jsonl")
    assert meta_cut["rounds"] == 3          # the original header kept
    assert [r.round for r in cut] == list(range(5))

    def strip(r):
        d = json.loads(r.to_json())
        d.pop("wall_time_s")
        return d

    assert [strip(r) for r in cut] == [strip(r) for r in full]
    assert sum(r.screened for r in cut) > 0
    with pytest.raises(SystemExit, match="needs --checkpoint-dir"):
        fl_train.main(flags + ["--resume"])
