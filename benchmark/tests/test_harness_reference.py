"""The reference against the port's plain CPU path at small sizes: the
same inputs through both give the same answers (the reference is a frozen
copy of those paths), stage by stage and through whole requests and
steps."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.reference import precision
from benchmark.reference.plain.ops import kernels as ref_kernels
from benchmark.reference.train import adam_run
from benchmark.readings import readings
from benchmark.tests.tiny import one_slot, tiny_cell

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_mean_shift_lap_and_distances_match_the_ports_plain_versions():
    from parsenet_tpu_torch.ops import kernels
    g = torch.Generator().manual_seed(3)
    x = torch.nn.functional.normalize(torch.randn(300, 16, generator=g),
                                      dim=1)
    for bf16 in (False, True):
        assert torch.equal(
            ref_kernels.mean_shift_iterations(x, 0.2, 7, bf16_dots=bf16),
            kernels.mean_shift_iterations(x, 0.2, 7, bf16_dots=bf16))
    cost = torch.rand(3, 20, 20, generator=g)
    assert torch.equal(ref_kernels.lap_assign(cost, 1e-5, 150, 8.0, 3000),
                       kernels.lap_assign(cost, 1e-5, 150, 8.0, 3000))
    q, t = torch.rand(2, 50, 3, generator=g), torch.rand(2, 70, 3,
                                                          generator=g)
    for a, b in zip(ref_kernels.min_sqdist_with_idx(q, t),
                    kernels.min_sqdist_with_idx(q, t)):
        assert torch.equal(a, b)


def test_the_control_rounds_mean_shift_to_float8():
    g = torch.Generator().manual_seed(4)
    x = torch.nn.functional.normalize(torch.randn(200, 16, generator=g),
                                      dim=1)
    base = ref_kernels.mean_shift_iterations(x, 0.3, 5, bf16_dots=True)
    with precision(low=True):
        low = ref_kernels.mean_shift_iterations(x, 0.3, 5, bf16_dots=True)
    assert ref_kernels.MS_LOW["dtype"] == torch.bfloat16
    assert float((low - base).abs().max()) > 1e-3


def test_adam_written_out_is_torchs_adam():
    g = torch.Generator().manual_seed(5)
    model = torch.nn.Linear(6, 3)
    twin = torch.nn.Linear(6, 3)
    twin.load_state_dict(model.state_dict())
    xs = [torch.randn(4, 6, generator=g) for _ in range(3)]
    out = adam_run(model, [[lambda x=x: model(x).square().mean()]
                           for x in xs], 0.01)
    opt = torch.optim.Adam(twin.parameters(), lr=0.01, betas=(0.9, 0.999),
                           eps=1e-8)
    for x in xs:
        opt.zero_grad()
        twin(x).square().mean().backward()
        opt.step()
    for (_, a), b in zip(model.named_parameters(), twin.parameters()):
        assert torch.allclose(a, b, atol=1e-7)
    assert len(out["losses"]) == 3 and set(out["grad"]) == set(out["change"])


@pytest.mark.parametrize("name", ["e2e-protocol", "e2e-segment",
                                  "normals-train", "e2e-train"])
def test_whole_requests_and_steps_agree(name, monkeypatch):
    """The cell's program on the CPU against the reference, at tiny sizes:
    every compared number within a hundredth of the cell's limit."""
    one_slot(monkeypatch)
    cell = tiny_cell(name)
    got = readings(cell, CPU, 2 ** 31 + 17, 1.0)["program"]
    assert set(got) == set(cell.limits)
    for k, v in got.items():
        assert np.isfinite(v) and v <= cell.limits[k] / 100, (k, v)
