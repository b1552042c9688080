"""The process plan of ``parallel.mesh`` against the JAX package's device
meshes on the CPU's 8 forced devices.

- ``gcd_pop_data_mesh(pop, n)`` over a grid of populations and process
  counts: the port's axis sizes are the JAX mesh's shape, and rank ``i``
  sits where the JAX mesh puts device ``i`` (the data index innermost).
- ``make_mesh``: the default 1-D pop mesh, the ``-1`` wildcard, three axes,
  and the JAX texts for two wildcards, an indivisible wildcard and too few
  processes.
- Each axis's lines (the ranks of one sub-group) are the JAX mesh's device
  lines along that axis; ``host_meshes`` lays hosts of consecutive ranks;
  ``processes_per_host`` reads the launcher's variable.
"""

import jax
import numpy as np
import pytest
import torch

from hyperscalees_t2i_tpu.parallel.mesh import gcd_pop_data_mesh as jgcd_pop_data_mesh
from hyperscalees_t2i_tpu.parallel.mesh import make_mesh as jmake_mesh
from hyperscalees_t2i_tpu_torch.parallel import mesh

torch.set_num_threads(1)
DEVS = jax.devices()


def _positions(jm):
    """{device index: its coordinates} of a JAX mesh."""
    grid = np.vectorize(lambda d: DEVS.index(d), otypes=[int])(jm.devices)
    return {int(grid[idx]): dict(zip(jm.axis_names, (int(i) for i in idx))) for idx in np.ndindex(grid.shape)}


@pytest.mark.parametrize("pop", [1, 2, 3, 4, 6, 8, 12, 16])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8])
def test_gcd_pop_data_plan_is_the_jax_mesh(pop, n):
    jm = jgcd_pop_data_mesh(pop, n, devices=DEVS[:n])
    pm = mesh.gcd_pop_data_mesh(pop, n, ranks=range(n))
    assert pm.shape == dict(jm.shape)
    assert list(pm.names) == list(jm.axis_names)
    assert {r: pm.coords(r) for r in pm.ranks} == _positions(jm)
    for axis in pm.names:  # the sub-groups' ranks: the JAX mesh's device lines
        jlines = sorted(tuple(int(DEVS.index(d)) for d in line)
                        for line in np.moveaxis(jm.devices, list(jm.axis_names).index(axis), -1).reshape(
                            -1, jm.shape[axis]))
        assert sorted(pm.lines(axis)) == jlines


@pytest.mark.parametrize("axes", [None, {"pop": -1}, {"pop": 2, "data": -1}, {"pop": -1, "data": 2},
                                  {"pop": 2, "data": 2, "tp": 2}, {"data": 4, "pop": 2}, {"pop": 3}])
def test_make_mesh_is_the_jax_layout(axes):
    jm = jmake_mesh(axes, devices=DEVS)
    pm = mesh.make_mesh(axes, ranks=range(len(DEVS)))
    assert pm.shape == dict(jm.shape) and pm.size == jm.devices.size
    assert {r: pm.coords(r) for r in pm.ranks} == _positions(jm)


@pytest.mark.parametrize("axes, n, msg", [({"pop": -1, "data": -1}, 8, "at most one mesh axis may be -1"),
                                          ({"pop": 3, "data": -1}, 8, "8 devices not divisible by 3"),
                                          ({"pop": 4, "data": 4}, 8, r"needs 16 devices, have 8")])
def test_make_mesh_refusals_are_the_jax_texts(axes, n, msg):
    with pytest.raises(ValueError, match=msg):
        jmake_mesh(axes, devices=DEVS[:n])
    with pytest.raises(ValueError, match=msg):
        mesh.make_mesh(axes, ranks=range(n))


def test_one_process_mesh_lines_groups_and_hosts(monkeypatch):
    pm = mesh.make_mesh()  # no launch: one process
    assert pm.shape == {"pop": 1} and pm.coords() == {"pop": 0} and pm.group("pop") is None
    two = mesh.make_mesh({"pop": 1, "data": 2}, ranks=[0, 1])
    assert two.line("data", 1) == (0, 1) and two.line("pop", 1) == (1,) and two.index("tp", 1) == 0
    with pytest.raises(RuntimeError, match="make_axis_groups has not run"):
        two.group("data", 0)
    with pytest.raises(ValueError, match="not on the mesh"):
        two.coords(5)
    hosts = mesh.host_meshes({"pop": 2, "data": 2}, 3)
    assert [h.ranks for h in hosts] == [(0, 1, 2, 3), (4, 5, 6, 7), (8, 9, 10, 11)]
    assert hosts[1].coords(6) == {"pop": 1, "data": 0}
    assert mesh.processes_per_host() == 1
    monkeypatch.setenv(mesh.PROCESSES_PER_HOST_ENV, "4")
    assert mesh.processes_per_host() == 4
