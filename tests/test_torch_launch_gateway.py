"""The port's serving launcher in its gateway modes, run in process on the
CPU (``--device cpu``): each mode prints the reference launcher's kind of
lines, every job ends DONE or shed with a typed reason, the flag checks
refuse what the reference refuses, and without ``--device cpu`` a gateway
mode targets CUDA (and raises on a machine without it)."""
import ast
import re

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch.serve import main  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(capsys, *argv):
    main(["--device", "cpu", *argv])
    return capsys.readouterr().out.splitlines()


def test_gateway_tenants_deadline(capsys):
    out = _run(capsys, "--gateway", "--tenants", "2", "--deadline-s", "200",
               "--batch", "5", "--max-new", "8")
    assert out[0] == ("engine: gateway (1 static replica(s), 2 tenant(s), "
                      "routing=affinity) (cpu)")
    jobs = [l for l in out if l.startswith("[tenant")]
    assert len(jobs) == 5
    assert {l.split("]")[0] for l in jobs} == {"[tenant0", "[tenant1"}
    assert all(len(ast.literal_eval(l.split("-> ")[1])) == 8 for l in jobs)
    assert out[-1] == ("deadline hit rate 1.00   shed 0   audit: 10 allows "
                       "/ 0 denies")


def test_gateway_infeasible_deadline_sheds_typed(capsys):
    out = _run(capsys, "--gateway", "--deadline-s", "0.001", "--batch", "3",
               "--max-new", "4")
    jobs = [l for l in out if l.startswith("[tenant")]
    assert len(jobs) == 3
    assert all("-> SHED (deadline_infeasible: " in l for l in jobs)
    assert out[-1].startswith("deadline hit rate 0.00   shed 3   audit: ")


def test_gateway_affinity_routing(capsys):
    out = _run(capsys, "--routing", "affinity", "--replicas", "3",
               "--tenants", "2", "--batch", "6", "--max-new", "8")
    assert out[0].startswith("engine: gateway (3 static replica(s), 2 "
                             "tenant(s), routing=affinity)")
    routing = next(l for l in out if l.startswith("routing decisions: "))
    assert int(re.search(r"'affinity': (\d+)", routing).group(1)) > 0
    reps = [l for l in out if l.startswith("  replica ")]
    assert len(reps) == 3
    assert sum(int(re.search(r"dispatched (\d+)", l).group(1))
               for l in reps) == 6


def test_gateway_disaggregated_1_to_2(capsys, tmp_path):
    path = tmp_path / "metrics.prom"
    out = _run(capsys, "--disaggregate", "1:2", "--batch", "4", "--max-new",
               "8", "--metrics-out", str(path))
    assert out[0].startswith("engine: gateway (1 prefill + 2 decode "
                             "replica(s), 2 tenant(s), routing=affinity)")
    assert any(re.fullmatch(r"page shipping: 4 ships, [0-9.]+ MB/ship", l)
               for l in out)
    roles = [re.search(r"\((\w+)\)", l).group(1)
             for l in out if l.startswith("  replica ")]
    assert roles == ["prefill", "decode", "decode"]
    assert out[-1].startswith("wrote ") and str(path) in out[-1]
    assert "kotta_gateway_page_ships_total 4" in path.read_text()


@pytest.mark.parametrize("preempt", [True, False])
def test_interactive_burst(capsys, preempt):
    out = _run(capsys, "--interactive-burst",
               *(() if preempt else ("--no-preempt",)))
    assert out[0].startswith("engine: gateway interactive-burst demo "
                             f"(preemption {'ON' if preempt else 'OFF'}; "
                             "4 slots, 4 batch jobs, 3 interactive)")
    jobs = [l for l in out if l.startswith("  interactive job ")]
    assert len(jobs) == 3
    if preempt:
        assert all(": DONE ttft=" in l for l in jobs)
        assert out[-2].startswith("preemptions 3   resumes 3   ")
        assert out[-1] == "audit: 3 preempt / 3 resume records"
    else:
        assert all(l.endswith("SHED (deadline_infeasible)") for l in jobs)
        assert out[-2].startswith("preemptions 0   resumes 0   ")


def test_chaos_seed(capsys):
    out = _run(capsys, "--chaos-seed", "0", "--batch", "4", "--max-new", "8",
               "--max-len", "64")
    assert out[0].startswith("engine: gateway chaos demo (seed 0, 0 pending "
                             "/ ")
    jobs = [l for l in out if l.startswith("  job ")]
    assert len(jobs) == 4
    assert all(": DONE" in l or "SHED (retry_budget_exhausted)" in l
               for l in jobs)
    assert any(l.startswith("notices ") for l in out)


def test_saturation(capsys):
    out = _run(capsys, "--saturation", "--max-new", "8")
    assert out[0].startswith("engine: gateway saturation demo (1 replica(s),"
                             " 2 tenant(s), open loop ")
    n = re.match(r"arrivals (\d+)   completed (\d+)   shed (\d+)", out[1])
    assert int(n.group(2)) + int(n.group(3)) == int(n.group(1)) > 0
    assert out[2].startswith("telemetry: ") and " job records, " in out[2]
    assert re.fullmatch(r"registry: \d+ metric families", out[3])


def test_flag_checks():
    with pytest.raises(SystemExit, match="requires a gateway mode"):
        main(["--device", "cpu", "--metrics-out", "x.prom"])
    with pytest.raises(SystemExit):
        main(["--device", "cpu", "--disaggregate", "0:1"])
    with pytest.raises(SystemExit, match="--replicas >= 1"):
        main(["--device", "cpu", "--gateway", "--replicas", "0"])
    with pytest.raises(SystemExit, match="paged-decode family"):
        main(["--device", "cpu", "--arch", "zamba2-1.2b", "--gateway"])


def test_gateway_mode_targets_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--gateway", "--batch", "1", "--max-new", "1"])
