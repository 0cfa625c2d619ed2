"""AdamW's kernels (humanrf_torch/csrc/adamw.cu, driven by
humanrf_torch/ops/adamw.py and `train/trainer.py::AdamW` on CUDA tensors).

On the CPU: the host-side planner that splits the pointer table into
launches, walked as the kernels walk it, and the tables it builds. On the
card (`cuda`-marked): the kernel route against the plain eager body
(`AdamW._update_plain`), bit for bit, after five steps.
"""
import ctypes

import pytest
import torch

from humanrf_torch.models.humanrf import HumanRFConfig, HumanRFModel
from humanrf_torch.ops import adamw as adamw_kernels
from humanrf_torch.train.trainer import AdamW, make_optimizer
from humanrf_torch.utils import profiling

# The paper's 1000-frame model (20 segments of 50 frames), in the order of
# its parameters: 106 tensors, 676,341,312 parameters.
PAPER_1000F = [p.numel() for p in HumanRFModel(HumanRFConfig(
    sorted_frame_numbers=tuple(range(1000)), segment_sizes=(50,) * 20, camera_embedding_dim=2),
    device="meta").parameters()]
PLANS = {
    "one": [2**20 + 5],
    "paper-1000f": PAPER_1000F,
    "300-small": [0 if i % 50 == 7 else (37 * i) % 5000 + 1 for i in range(300)],  # six of 0 elements
}


def _walk(launch: adamw_kernels.Launch, numels, blocks: int):
    """The (tensor, offset, length) of every chunk, as a launch of `blocks`
    blocks visits them: each block walks its chunks grid-stride, finding a
    chunk's tensor by advancing a cursor (csrc/adamw.cu `tensor_of`)."""
    out = []
    for b in range(blocks):
        i = 0
        for c in range(b, launch.n_chunks, blocks):
            while i + 1 < len(launch.tensors) and c >= launch.chunk0[i + 1]:
                i += 1
            n = numels[launch.tensors[i]]
            off = (c - launch.chunk0[i]) * adamw_kernels.CHUNK
            out.append((launch.tensors[i], off, min(adamw_kernels.CHUNK, n - off)))
    return out


@pytest.mark.parametrize("name", list(PLANS))
def test_planner_covers_every_element_once_within_the_parameter_limit(name):
    """Every element of every tensor lies in exactly one chunk of one launch
    (tensors of no element in none), walked as the kernels walk the table at
    a few grid sizes; no launch takes more than MAX_TENSORS tensors, and one
    launch's parameters (its table, the constants and a pointer) fit the 32 KB
    that a kernel's parameters may hold."""
    numels = PLANS[name]
    if name == "paper-1000f":
        assert (len(numels), sum(numels)) == (106, 676_341_312)
    launches = adamw_kernels.plan(numels)
    assert all(1 <= len(la.tensors) <= adamw_kernels.MAX_TENSORS for la in launches)
    assert len(launches) == -(-sum(n > 0 for n in numels) // adamw_kernels.MAX_TENSORS)
    assert [i for la in launches for i in la.tensors] == [i for i, n in enumerate(numels) if n > 0]
    for blocks in (1, 7, 1056):
        spans = {}
        for launch in launches:
            for i, off, length in _walk(launch, numels, blocks):
                assert length >= 1
                spans.setdefault(i, []).append((off, length))
        assert set(spans) == {i for i, n in enumerate(numels) if n > 0}
        for i, chunks in spans.items():
            end = 0
            for off, length in sorted(chunks):
                assert off == end, (i, off, end)  # no gap, no overlap
                end = off + length
            assert end == numels[i]
    assert ctypes.sizeof(adamw_kernels.AdamWTensor) == 48
    params = ctypes.sizeof(adamw_kernels.AdamWTable) + ctypes.sizeof(adamw_kernels.AdamWConstants) + 8
    assert ctypes.sizeof(adamw_kernels.AdamWTable) == 16 + 48 * adamw_kernels.MAX_TENSORS
    assert params <= adamw_kernels.PARAM_LIMIT


def test_tables_hold_the_tensors_as_they_are_and_refuse_other_layouts():
    """The tables point at each tensor's storage, a None gradient at
    nothing, with its size and first chunk; a tensor that is not contiguous
    float32, or not its parameter's size, raises."""
    params = [torch.zeros(n) for n in (3, 0, 5000, 1)]
    grads = [torch.ones(3), None, torch.ones(5000), None]
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    (tab,) = adamw_kernels.tables(params, grads, mu, nu)
    assert (tab.n_tensors, tab.n_chunks) == (3, 1 + 3 + 1)
    rows = [(t.p, t.g, t.m, t.v, t.n, t.chunk0) for t in tab.t[:3]]
    assert rows == [(params[0].data_ptr(), grads[0].data_ptr(), mu[0].data_ptr(), nu[0].data_ptr(), 3, 0),
                    (params[2].data_ptr(), grads[2].data_ptr(), mu[2].data_ptr(), nu[2].data_ptr(), 5000, 1),
                    (params[3].data_ptr(), None, mu[3].data_ptr(), nu[3].data_ptr(), 1, 4)]
    # a double, a strided and a longer gradient; a transposed parameter
    for grad in (torch.ones(3, dtype=torch.float64), torch.ones(6)[::2], torch.ones(4)):
        with pytest.raises(TypeError):
            adamw_kernels.tables(params[:1], [grad], mu[:1], nu[:1])
    with pytest.raises(TypeError):
        adamw_kernels.tables([torch.zeros(4, 4).T], [None], [torch.zeros(4, 4)], [torch.zeros(4, 4)])


# ------------------------------------------------------------------ the card

class PlainAdamW(AdamW):
    """The oracle: the plain eager body, on CUDA tensors too."""

    def _update_kernels(self, step_size, bc1, bc2):
        return self._update_plain(step_size, bc1, bc2)


CARD_CASES = {
    # shapes, the (step, tensor) whose gradient holds a NaN, the tensor without a gradient
    "sizes": dict(shapes=[(1,), (3,), (4,), (1023,), (2**20 + 5,), (37, 129)]),
    "many": dict(shapes=[((17 * i) % 3001 + 1,) for i in range(300)]),
    "none-grad": dict(shapes=[(1023,), (4096,), (5,)], no_grad=1),
    "nonfinite": dict(shapes=[(1,), (1023,), (2**20 + 5,), (37, 129)], nan=(2, 2)),
    "unaligned": dict(shapes=[(1023,), (4097,), (6,)], unaligned=True),
    "graph": dict(shapes=[(3,), (1023,), (2**20 + 5,), (37, 129)], graph=True, nan=(3, 1)),
}
STEPS = 5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _grads(shapes, steps, device, nan=None, no_grad=None):
    """Per step a gradient per tensor: normal values at scales 1e-6..10 with
    exact zeros among them; a NaN (and an inf beside it) at `nan`'s (step,
    tensor); None for tensor `no_grad`."""
    gen = torch.Generator().manual_seed(18)
    out = []
    for step in range(steps):
        grads = []
        for i, shape in enumerate(shapes):
            g = torch.randn(shape, generator=gen) * 10.0 ** torch.randint(-6, 2, shape, generator=gen)
            g = torch.where(torch.rand(shape, generator=gen) < 0.05, 0.0, g)
            if nan == (step, i):
                g.view(-1)[g.numel() // 2] = float("nan")
                g.view(-1)[-1] = float("inf")
            grads.append(None if i == no_grad else g.to(device))
        out.append(grads)
    return out


def _state(opt):
    bits = [t.view(torch.int32).clone() for t in (*opt.params, *opt.mu, *opt.nu)]
    return bits + [t.clone() for t in (opt.count, opt.skipped, opt.notfinite_count, opt.last_finite)]


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CARD_CASES))
def test_kernels_equal_the_plain_body_on_card(cuda_device, name):
    """Five steps of the kernel route against the plain eager body from the
    same parameters and gradients: parameters, both moments (bit for bit),
    `count`, `skipped`, `notfinite_count` and `last_finite` equal. Cases:
    sizes with unaligned tails and a 2-D tensor; 300 tensors (two tables);
    a None gradient; a NaN step, skipped; gradients as views at an odd
    offset (the element-by-element walk); the steps after the first
    captured in a CUDA graph and replayed."""
    case = CARD_CASES[name]
    shapes = case["shapes"]
    gen = torch.Generator().manual_seed(0)
    init = [torch.randn(s, generator=gen).to(cuda_device) for s in shapes]
    kernel_params = [torch.nn.Parameter(p.clone()) for p in init]
    plain_params = [torch.nn.Parameter(p.clone()) for p in init]
    names = [f"t{i}" for i in range(len(shapes))]
    kernel = make_optimizer(zip(names, kernel_params), 1e-2, 0.5, 50_001, weight_decay=0.03)
    plain = PlainAdamW(zip(names, plain_params), 1e-2, 0.5, 50_001, weight_decay=0.03)
    steps = _grads(shapes, STEPS, cuda_device, case.get("nan"), case.get("no_grad"))

    def set_grads(params, grads):
        for p, g in zip(params, grads):
            if g is None:
                p.grad = None
            elif case.get("unaligned"):
                buf = torch.empty(g.numel() + 1, device=cuda_device)
                buf[1:].copy_(g.reshape(-1))
                p.grad = buf[1:].view(g.shape)
            elif p.grad is None:
                p.grad = g.clone()
            else:
                p.grad.copy_(g)  # in place: a captured graph reads these buffers

    before = dict(adamw_kernels.launches)
    for grads in steps:
        set_grads(plain_params, grads)
        plain.step()
    set_grads(kernel_params, steps[0])
    kernel.step()
    if case.get("graph"):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            kernel.step()
        for grads in steps[1:]:
            set_grads(kernel_params, grads)
            graph.replay()
    else:
        for grads in steps[1:]:
            set_grads(kernel_params, grads)
            kernel.step()
    torch.cuda.synchronize()

    tables = -(-len(shapes) // adamw_kernels.MAX_TENSORS)
    eager_steps = 2 if case.get("graph") else STEPS  # the first step and the capture
    assert profiling.snapshot()["counters"]["train.optimizer_launches"] == 2 * tables
    assert {k: adamw_kernels.launches[k] - before[k] for k in before} == {"finite": eager_steps * tables,
                                                                         "update": eager_steps * tables}
    skips = int(case.get("nan") is not None)
    assert (int(kernel.count), int(kernel.skipped)) == (STEPS - skips, skips)
    got, want = _state(kernel), _state(plain)
    labels = [f"{kind} {i}" for kind in ("param", "mu", "nu") for i in range(len(shapes))]
    labels += ["count", "skipped", "notfinite_count", "last_finite"]
    for label, a, b in zip(labels, got, want):
        assert torch.equal(a, b), f"{name}: {label} differs from the plain body"
