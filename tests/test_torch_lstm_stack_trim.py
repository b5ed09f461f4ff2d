"""K1 at the layers' own widths, on the CPU.

A pack pads every layer of a segment to one width (W=32 for gw_nominal's
32-8-8-32 stack).  Given the pack's real widths, the row-blocked kernel
runs only the warps of real elements and ends each chain at its layer's
width rounded up to 4; the plain version (``lstm_stack_ref(...,
widths=)``) does the same on the CPU, and writes +0 at every padded
position.  Held here, bit for bit (the tensors' bits, so signed zeros
count), against the padded plain version:

* gw_nominal's encoder and decoder packs, and two stacks at widths that are
  not multiples of 8 (hidden 32 then 12, and 20 then 32);
* EXACT, HARD and PAPER_HW_KERNEL, fp32, bf16 and int8 packs, with and
  without ``act_bits``;
* inputs and states that hold +0 and -0, and the decoder's repeated stream.

A state that holds other values at its padded positions (one handed in at
the pack width) reaches no real output: those keep the padded bits.  Also:
every caller of a pack (``lstm_stack_forward_fused``, the executor's
packed-state step and the sharded stages) hands the pack's widths down,
direct calls hand none, ``trims`` and ``launch``'s refusals.  The kernel side runs only on the card
(``tests/test_torch_lstm_stack_trim_cuda.py``).
"""

import dataclasses
import sys

import pytest
import torch

from repro_torch.configs.gw import GW_MODELS
from repro_torch.core.autoencoder import decoder_layers, encoder_layers, init_autoencoder
from repro_torch.core.lstm import LstmConfig, init_lstm
from repro_torch.core.quant import EXACT, HARD, PAPER_HW_KERNEL, make_act_quant
from repro_torch.kernels.lstm_stack import lstm_stack, lstm_stack_ref, ops
from repro_torch.kernels.lstm_stack.ops import pack_stack, project_layer0

# the module, not the function the package re-exports under its name
k1 = sys.modules["repro_torch.kernels.lstm_stack.lstm_stack"]

T_LEN, BATCH = 6, 5
STORAGE = {
    "fp32": dict(weight_dtype="fp32"),
    "bf16w": dict(weight_dtype="bf16"),
    "bf16": dict(weight_dtype="bf16", dtype=torch.bfloat16),
    "int8": dict(weight_dtype="int8"),
}
ACTS = {a.name: a for a in (EXACT, HARD, PAPER_HW_KERNEL)}
#: (segment, in_dims, hidden): gw_nominal's two segments, and two stacks
#: whose widths are not multiples of 8, each packed to W=32
STACKS = {
    "nominal_enc": ((1, 32), (32, 8)),
    "nominal_dec": ((8, 8), (8, 32)),
    "h32_h12": ((1, 32), (32, 12)),
    "h20_h32": ((1, 20), (20, 32)),
}


def bits(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bits: +0 and -0 differ."""
    return t.view({torch.float32: torch.int32, torch.bfloat16: torch.int16}[t.dtype])


def assert_bits_equal(got, want, what):
    for a, b in zip(got, want, strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape, what
        assert torch.equal(bits(a), bits(b)), what


def _layers(stack, storage, acts=EXACT, seed=0):
    """(params, cfgs) of ``stack``'s layers: gw_nominal's own segments from
    ``init_autoencoder``, the others from ``init_lstm``, with biases drawn
    at every real position."""
    kw = STORAGE[storage]
    if stack.startswith("nominal"):
        cfg = dataclasses.replace(GW_MODELS["gw_nominal"], acts=acts, **kw)
        params = init_autoencoder(cfg, seed=seed, device="cpu")
        return (encoder_layers if stack == "nominal_enc" else decoder_layers)(params, cfg)
    g = torch.Generator().manual_seed(seed)
    in_dims, hidden = STACKS[stack]
    cfgs = [LstmConfig(in_dim=i, hidden=h, dtype=kw.get("dtype", torch.float32), acts=acts,
                       weight_dtype=kw["weight_dtype"]) for i, h in zip(in_dims, hidden)]
    params = []
    for c in cfgs:
        p = init_lstm(c, g, device="cpu")
        p["b"] = torch.randn(4 * c.hidden, generator=g) * 0.5
        params.append(p)
    return params, cfgs


def _pack(stack, storage, acts=EXACT, seed=0):
    return pack_stack(*_layers(stack, storage, acts, seed))


def _signed(shape, seed, scale=1.0):
    """Random values with exact +0 and -0 among them."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g) * scale
    pick = torch.randint(0, 4, shape, generator=g)
    return torch.where(pick == 0, torch.zeros(()), torch.where(pick == 1, -torch.zeros(()), x))


def _operands(pk, seed, zero_state, repeated=False):
    """Layer 0's gate stream (from an input holding +0 and -0) and a packed
    state: the zero state, or a real-width state holding +0 and -0."""
    d_in = pk.in_dims[0]
    if repeated:
        x = _signed((BATCH, 1, d_in), seed).expand(BATCH, T_LEN, d_in)
    else:
        x = _signed((BATCH, T_LEN, d_in), seed)
    xw0 = project_layer0(pk.pad_input(x.to(pk.dtype)), pk.stacked, pk.weight_dtype)
    if zero_state:
        h0, c0 = pk.zero_state(BATCH)
    else:
        h0, c0 = pk.pack_state([(_signed((BATCH, h), seed + 1 + l, 0.5),
                                 _signed((BATCH, h), seed + 11 + l, 0.5))
                                for l, h in enumerate(pk.hidden)])
    return xw0, h0, c0


def _plain(pk, xw0, h0, c0, acts, act_bits, widths=None):
    s = pk.stacked
    return lstm_stack_ref(xw0, s["w_x"], s["w_h"], s["b"], h0, c0, scales=s.get("scales"),
                          sigma=acts.sigma, tanh=acts.tanh,
                          act_quant=make_act_quant(act_bits) if act_bits else None,
                          widths=widths)


@pytest.mark.parametrize("act_bits", [None, 16])
@pytest.mark.parametrize("acts", list(ACTS))
@pytest.mark.parametrize("storage", list(STORAGE))
@pytest.mark.parametrize("stack", list(STACKS))
def test_plain_version_at_real_widths_has_the_padded_bits(stack, storage, acts, act_bits):
    """hs, h_f and c_f of the whole (padded) tensors, on the zero state and
    on a real-width state, equal the padded plain version's bits; every
    padded position is +0."""
    pk = _pack(stack, storage, ACTS[acts])
    assert (pk.width_p, (pk.in_dims, pk.hidden)) == (32, STACKS[stack])
    for zero_state in (True, False):
        seed = len(stack) + 7 * zero_state
        xw0, h0, c0 = _operands(pk, seed, zero_state, repeated=stack == "nominal_dec")
        want = _plain(pk, xw0, h0, c0, ACTS[acts], act_bits)
        got = _plain(pk, xw0, h0, c0, ACTS[acts], act_bits, widths=pk.widths)
        assert_bits_equal(got, want, (stack, storage, acts, act_bits, zero_state))
        hs, h_f, c_f = got
        last = pk.hidden[-1]
        assert torch.equal(bits(hs[..., last:]), torch.zeros_like(bits(hs[..., last:])))
        for l, h in enumerate(pk.hidden):
            for t in (h_f[l, :, h:], c_f[l, :, h:]):
                assert torch.equal(bits(t), torch.zeros_like(bits(t))), (stack, l)


@pytest.mark.parametrize("stack", list(STACKS))
def test_cpu_lstm_stack_takes_the_widths_to_its_plain_version(stack):
    """On CPU tensors ``lstm_stack`` runs the plain version with the widths
    it is given, counts no launch, and keeps the padded bits."""
    pk = _pack(stack, "fp32")
    s = pk.stacked
    xw0, h0, c0 = _operands(pk, 3, zero_state=False)
    before = (lstm_stack.launches, lstm_stack.trimmed_launches)
    got = lstm_stack(xw0, s["w_x"], s["w_h"], s["b"], h0, c0, widths=(pk.in_dims, pk.hidden))
    assert (lstm_stack.launches, lstm_stack.trimmed_launches) == before
    assert_bits_equal(got, lstm_stack(xw0, s["w_x"], s["w_h"], s["b"], h0, c0), stack)


@pytest.fixture
def recorded(monkeypatch):
    """Each call's ``widths`` as ``ops`` hands it to ``lstm_stack``."""
    calls = []
    real = ops.lstm_stack

    def record(*args, widths=None, **kw):
        calls.append(widths)
        return real(*args, widths=widths, **kw)

    monkeypatch.setattr(ops, "lstm_stack", record)
    return calls


@pytest.mark.parametrize("stack", list(STACKS))
def test_forward_fused_hands_the_pack_widths_down(stack, recorded):
    """From the zero state and from a state at the real widths: the pack's
    (in_dims, hidden), and the padded bits."""
    params, cfgs = _layers(stack, "fp32")
    pk = pack_stack(params, cfgs)
    g = torch.Generator().manual_seed(2)
    xs = torch.randn(BATCH, T_LEN, pk.in_dims[0], generator=g)
    state = [(torch.randn(BATCH, h, generator=g) * 0.5, torch.randn(BATCH, h, generator=g) * 0.5)
             for h in pk.hidden]
    for initial in (None, state):
        got_hs, got_state = ops.lstm_stack_forward_fused(params, xs, cfgs, initial, packed=pk)
        assert recorded.pop() == (pk.in_dims, pk.hidden)
        h0, c0 = pk.zero_state(BATCH) if initial is None else pk.pack_state(initial)
        want = ops.lstm_stack_op(pk.pad_input(xs), pk.stacked, h0, c0, acts=pk.acts,
                                 weight_dtype=pk.weight_dtype)
        assert recorded.pop() is None  # a direct call hands none
        assert torch.equal(bits(got_hs), bits(want[0][..., : pk.hidden[-1]]))
        for l, (h, c) in enumerate(got_state):
            assert torch.equal(bits(h), bits(want[1][l, :, : pk.hidden[l]]))
            assert torch.equal(bits(c), bits(want[2][l, :, : pk.hidden[l]]))


@pytest.mark.parametrize("stack", list(STACKS))
def test_forward_fused_hands_the_widths_down_for_a_state_at_the_pack_width(stack, recorded):
    """A state already at the pack width may hold anything at the padded
    positions: the widths still go down, and every real output keeps the
    padded work's bits."""
    params, cfgs = _layers(stack, "fp32")
    pk = pack_stack(params, cfgs)
    xs = _signed((BATCH, T_LEN, pk.in_dims[0]), 4)
    wide = [(_signed((BATCH, pk.width_p), 5 + l, 0.5), _signed((BATCH, pk.width_p), 15 + l))
            for l in range(pk.n_layers)]
    got_hs, got_state = ops.lstm_stack_forward_fused(params, xs, cfgs, wide, packed=pk)
    assert recorded.pop() == pk.widths == (pk.in_dims, pk.hidden)
    h0, c0 = torch.stack([h for h, _ in wide]), torch.stack([c for _, c in wide])
    want = ops.lstm_stack_op(pk.pad_input(xs), pk.stacked, h0, c0, acts=pk.acts,
                             weight_dtype=pk.weight_dtype)
    assert recorded == [None]
    assert torch.equal(bits(got_hs), bits(want[0][..., : pk.hidden[-1]]))
    for l, (h, c) in enumerate(got_state):
        assert torch.equal(bits(h), bits(want[1][l, :, : pk.hidden[l]]))
        assert torch.equal(bits(c), bits(want[2][l, :, : pk.hidden[l]]))


@pytest.mark.parametrize("act_bits", [None, 16])
@pytest.mark.parametrize("acts", list(ACTS))
@pytest.mark.parametrize("storage", list(STORAGE))
@pytest.mark.parametrize("stack", list(STACKS))
def test_plain_version_at_real_widths_reads_no_padded_state(stack, storage, acts, act_bits):
    """A packed state holding +0, -0 and other values at every position,
    the padded ones too: each real position of hs, h_f and c_f has the
    padded plain version's bits."""
    pk = _pack(stack, storage, ACTS[acts])
    xw0, _, _ = _operands(pk, 21, zero_state=True, repeated=stack == "nominal_dec")
    shape = (pk.n_layers, BATCH, pk.width_p)
    h0, c0 = _signed(shape, 22, 0.5).to(pk.dtype), _signed(shape, 23)
    want = _plain(pk, xw0, h0, c0, ACTS[acts], act_bits)
    got = _plain(pk, xw0, h0, c0, ACTS[acts], act_bits, widths=pk.widths)
    what = (stack, storage, acts, act_bits)
    last = pk.hidden[-1]
    assert torch.equal(bits(got[0][..., :last]), bits(want[0][..., :last])), what
    for l, h in enumerate(pk.hidden):
        for g, w in zip(got[1:], want[1:]):
            assert torch.equal(bits(g[l, :, :h]), bits(w[l, :, :h])), (what, l)


@pytest.mark.parametrize("stack", list(STACKS))
def test_the_packed_state_step_hands_the_widths_down(stack, recorded):
    """The executor's step on packed state (the streaming engines' call)
    hands the pack's widths down, and carries the padded work's bits."""
    from repro_torch.core import executor as tex

    params, cfgs = _layers(stack, "fp32")
    ex = tex.plan_stack(cfgs, impl="fused_stack").bind(params)
    state = ex.zero_state(BATCH)
    for seed in (6, 7):
        xs = _signed((BATCH, T_LEN, cfgs[0].in_dim), seed)
        hs, (h_f, c_f) = ex.step_with_output(xs, state)
        assert recorded.pop() == ex.packed.widths
        want = ops.lstm_stack_op(ex.packed.pad_input(xs), ex.packed.stacked, *state,
                                 acts=ex.packed.acts, weight_dtype=ex.packed.weight_dtype)
        assert_bits_equal((hs, h_f, c_f), (want[0][..., : cfgs[-1].hidden],) + want[1:], seed)
        recorded.clear()
        state = (h_f, c_f)


@pytest.mark.parametrize("n_stages", [1, 2])
@pytest.mark.parametrize("stack", list(STACKS))
def test_sharded_stages_hand_their_widths_down(stack, n_stages, recorded):
    """Each stage of a sharded stack hands its sub-stack's real widths
    down, one call a stage and chunk."""
    from repro_torch.core import executor as tex

    params, cfgs = _layers(stack, "fp32")
    ex = tex.plan_stack(cfgs, impl="fused_stack", placement="sharded", mesh=("cpu",) * n_stages,
                        n_chunks=2).bind(params)
    per = len(cfgs) // n_stages
    want = [(ex.packed.in_dims[s * per:(s + 1) * per], ex.packed.hidden[s * per:(s + 1) * per])
            for s in range(n_stages)]
    assert list(ex.staged.widths) == want
    ex(_signed((BATCH, T_LEN, cfgs[0].in_dim), 8))
    assert sorted(recorded) == sorted(want * 2)


def test_the_fused_backend_hands_the_widths_down(recorded):
    """A gw_nominal score through ``fused_stack`` (the benchmark's path)
    hands both segments' real widths to ``lstm_stack``."""
    from repro_torch.core.autoencoder import reconstruction_error

    cfg = dataclasses.replace(GW_MODELS["gw_nominal"], impl="fused_stack")
    params = init_autoencoder(cfg, seed=1, device="cpu")
    x = torch.randn(3, cfg.timesteps, 1, generator=torch.Generator().manual_seed(0))
    reconstruction_error(params, x, cfg)
    assert recorded == [((1, 32), (32, 8)), ((8, 8), (8, 32))]


@pytest.mark.parametrize("widths,width,want", [
    (((1, 32), (32, 8)), 32, True),     # gw_nominal's encoder
    (((8, 8), (8, 32)), 32, True),      # its decoder
    (((1, 32), (32, 32)), 32, False),   # only layer 0's input is narrow: streamed in
    (((32,), (32,)), 32, False),
    (((1,), (9,)), 9, False),           # gw_small's pack
    (((1, 32), (32, 12)), 32, True),
    (None, 32, False),
])
def test_trims(widths, width, want):
    assert k1.trims(widths, width) is want


def _launch(path, widths, n_layers=2, width=32):
    """``launch`` on zero CPU operands of batch 5."""
    batch, t_len = 5, 2
    w = torch.zeros(n_layers, width, 4 * width)
    h0 = c0 = torch.zeros(n_layers, batch, width)
    x = torch.zeros(t_len, batch, 4 * width)
    out = (torch.zeros(t_len, batch, width), torch.zeros_like(h0), torch.zeros_like(c0))
    k1.launch("lstm_stack_wavefront", x, w, w, torch.zeros(n_layers, 4 * width), h0, c0, None,
              *out, t_len=t_len, acts=EXACT, act_bits=None, path=k1.KernelPath(*path),
              widths=widths)


@pytest.mark.parametrize("path,widths,match", [
    (("one_row", 1), ((1, 32), (32, 8)), "blocked path only"),
    (("row_thread", 64), ((1,), (9,)), "blocked path only"),
    (("blocked", 8), ((1,), (32,)), "not the real widths"),          # one layer of two
    (("blocked", 8), ((1, 32), (32, 0)), "not the real widths"),
    (("blocked", 8), ((1, 33), (32, 8)), "not the real widths"),     # wider than the pack
])
def test_launch_refuses_widths_it_cannot_take(path, widths, match):
    """Refused before the library is built or loaded."""
    with pytest.raises(ValueError, match=match):
        _launch(path, widths, n_layers=1 if path[0] == "row_thread" else 2,
                width=9 if path[0] == "row_thread" else 32)


def test_widths_arg_is_the_libraries_layout():
    arr = k1.widths_arg(((1, 32), (32, 8)), 2, 32)
    assert list(arr) == [1, 32, 32, 8]
    assert k1.widths_arg(None, 2, 32) is None
