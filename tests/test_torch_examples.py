"""The port's four examples (``repro_torch.examples``), each run through its
``main`` on the CPU with its shortest settings, and held to what the
reference's example shows and chip_smoke.py's examples phase checks:

- ``secure_analytics``: alice's WOS job COMPLETED with topics equal to a
  numpy count of the same shards; bob denied WOS at submit, with a deny
  record for it in the audit; bob's wikipedia job COMPLETED; the cold-shard
  job parked (WAITING_DATA), then COMPLETED; every thread joined;
- ``quickstart``: the loss falls over 6 steps, and the trained model serves;
- ``elastic_training``: 12 steps at a bid of 0.05 survive the revocation
  at step 10 (the default bid's comes at step 20);
- ``serve_demo``: 4 prompts answered from weights that came back from the
  object store bit for bit."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.core import JobStatus  # noqa: E402
from repro_torch.examples import (elastic_training, quickstart,  # noqa: E402
                                  secure_analytics, serve_demo)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _numpy_topics(shards):
    """Top 5 (topic, count), most frequent first, ties by topic."""
    ids = np.concatenate([np.frombuffer(s, dtype=np.int32) for s in shards])
    counts = np.bincount(ids % 97, minlength=97)
    order = np.lexsort((np.arange(97), -counts))[:5]
    return [(int(t), int(counts[t])) for t in order]


def test_secure_analytics(capsys):
    out = secure_analytics.main(device="cpu", tokens=1024)
    status, wos, topics = out["alice"]
    assert status == JobStatus.COMPLETED
    assert topics == repr(_numpy_topics(out["store"].get(k) for k in wos))
    assert out["bob"] == JobStatus.COMPLETED
    assert out["cold"] == (JobStatus.WAITING_DATA, JobStatus.COMPLETED)
    assert [(d.principal_id, d.resource) for d in out["denials"]] \
        == [("bob", "dataset/wos/shard-0")]
    assert out["threads_alive"] == []
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("[alice] WOS job JobStatus.COMPLETED: [(")
    assert lines[1] == "[bob]   denied WOS as expected: AuthorizationError"
    assert lines[-1].endswith("1 denials (e.g. bob -> dataset/wos/shard-0)")


def test_quickstart(capsys):
    out = quickstart.main(device="cpu", steps=6)
    assert out["losses"][6] < out["losses"][1]
    assert np.array(out["completions"]).shape == (2, 8)
    assert out["checkpoints"] == [3, 6]
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("loss: step1=") and "step6=" in lines[0]
    assert lines[2].startswith("checkpoints in store: [3, 6]")


def test_elastic_training(capsys):
    out = elastic_training.main(device="cpu", steps=12, bid=0.05)
    rep = out["report"]
    assert out["revoked_steps"] == [10] and rep.restarts == 1
    assert rep.final_step == 12 and out["checkpoints"] == [10, 12]
    assert rep.losses[12] < rep.losses[1]
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "model: 5.0M params, 12 steps"
    assert "(1 revocations at [10])" in lines[1]


def test_serve_demo(capsys):
    out = serve_demo.main(device="cpu", max_new=4)
    for name, leaf in out["params"]["layers"]["attn"].items():
        assert torch.equal(out["restored"]["layers"]["attn"][name], leaf)
    assert [len(t) for t in out["tokens"]] == [4] * 4
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "restored 12 weight tensors from the object store"
    assert lines[1].startswith("prompt [1, 2, 3] -> [")
    assert lines[-1].startswith("16 tokens in ")
