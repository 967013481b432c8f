"""ShardedUnstructuredProblem.run() (parallel/unstructured.py) on gloo
ranks: the twin of tests/test_sharded.py's
test_unstructured_distributed_matches_single under the reference test's
config and bounds, a box problem through the same wrapper, and the
wrapper's refusals. The ranks start first; the single-device runs (the
port's and the reference's) overlap them."""

import numpy as np
import pytest
import torch

from pynama_tpu.cases.analytic import CustomFuncProblem as RefCustomFunc
from pynama_tpu_torch.parallel import launch
from tests import torch_dist_cases as cases
from tests.test_unstructured import box_corner_mesh

# seconds the ranks may take: the 4-rank twin (~1,450 all-reduces a
# rank) took 7 s on an idle 8-core host
DEADLINE = 300.0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_msh(path):
    """tests/test_sharded.py's mesh file: 4x4 quads distorted by 0.03."""
    pts, quads = box_corner_mesh(4, 4, distort=0.03)
    with open(path, "w") as f:
        f.write("$MeshFormat\n2.2 0 8\n$EndMeshFormat\n")
        f.write(f"$Nodes\n{len(pts)}\n")
        for i, p in enumerate(pts):
            f.write(f"{i+1} {p[0]:.17g} {p[1]:.17g} 0\n")
        f.write("$EndNodes\n")
        f.write(f"$Elements\n{len(quads)}\n")
        for i, q in enumerate(quads):
            f.write(f"{i+1} 3 2 1 1 " + " ".join(str(v + 1) for v in q)
                    + "\n")
        f.write("$EndElements\n")


def twin_config(msh):
    """tests/test_sharded.py's config of the twin."""
    return {
        "name": "tg2d-dist",
        "material-properties": {"rho": 1.0, "mu": 0.01},
        "domain": {"ngl": 4, "gmsh-file": str(msh)},
        "time-solver": {"start-time": 0.0, "end-time": 0.05, "max-steps": 30},
        "kle-rtol": 1e-11,
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    msh = tmp_path_factory.mktemp("unstructured_dist") / "tg2d.msh"
    write_msh(msh)
    cfg, box = twin_config(msh), cases.tg_config()
    four = launch.start(cases.run_jobs, 4, args=([
        ("twin", "unstructured_run", ("taylor-green", cfg)),
        ("refusals", "unstructured_refusals", ("taylor-green", cfg))],))
    two = launch.start(cases.run_jobs, 2, args=([
        ("box", "unstructured_run", ("taylor-green", box))],))
    p = RefCustomFunc(cfg, case="taylor-green").setup()
    w_ref, t_ref, n_ref = p.run()
    out = {"ref": (np.asarray(w_ref).reshape(-1), float(t_ref), n_ref),
           "port": cases.single_run("taylor-green", cfg),
           "port_box": cases.single_run("taylor-green", box),
           "four": four.join(DEADLINE), "two": two.join(DEADLINE)}
    return out


def rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def test_unstructured_distributed_matches_single(runs):
    """Element-partitioned data parallelism on a distorted Gmsh quad mesh
    (replicated state, all-reduced applies) on 4 gloo ranks matches the
    reference's and the port's single-device runs."""
    w, t, n, iters, n_ar = runs["four"][0]["twin"]
    for key in ("ref", "port"):
        w_ref, t_ref, n_ref = runs[key]
        assert n == n_ref
        assert abs(t - t_ref) < 1e-14
        assert rel(w, w_ref) < 1e-10, key
    # every rank holds the same state and made the same collectives:
    # Rw, K bc, SrT, Div and Curl once a solve, and K once a CG
    # iteration and once for the first residual
    for r in runs["four"]:
        assert np.array_equal(r["twin"][0], w)
        assert r["twin"][4] == n_ar
    assert n_ar == sum(iters) + 6 * len(iters)


def test_unstructured_distributed_box_problem(runs):
    """The same wrapper on a box problem (4x8 Q2 Taylor-Green,
    Jacobi-CG) on 2 ranks: its masks and fields read flat in node order,
    the shared elemental matrices as one GEMM a chunk."""
    w, t, n, _, _ = runs["two"][0]["box"]
    w_ref, t_ref, n_ref = runs["port_box"]
    assert n == n_ref
    assert abs(t - t_ref) < 1e-14
    assert rel(w, w_ref) < 1e-10
    assert np.array_equal(runs["two"][1]["box"][0], w)


@pytest.mark.parametrize("name", ["n_dev", "device"])
def test_unstructured_distributed_refusals(runs, name):
    """n_dev other than the group's size, and a problem on the card in a
    gloo group, raise ValueError on every rank."""
    want = {"n_dev": "process group of 4 ranks for a (5,) device grid",
            "device": "a problem on cuda:0 in a gloo group"}[name]
    for r in runs["four"]:
        assert r["refusals"][name] is not None
        assert r["refusals"][name].startswith(want)
