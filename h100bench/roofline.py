"""The benchmark's frozen yardstick: published peaks of one H100 and the
operations and bytes each measured kernel needs, as functions of shapes
alone.

Peaks are NVIDIA's data sheet for the H100 SXM at its 700 W limit, dense
rates without sparsity.  The scan's bound counts its exps on the
special-function units at 16 results per SM per clock, over the 132 SMs at
the published 1,980 MHz boost clock: a constant, so the yardstick does not
move with the clock of the card that runs.  Nothing here reads the card.
"""
from __future__ import annotations

PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12,
              "float64": 67e12}
PEAK_BYTES = 3.35e12                     # HBM3, bytes/s
SFU_PER_SM_CLOCK = 16                    # exp results per SM per clock
SMS = 132
BOOST_CLOCK_HZ = 1.98e9
EXP_RATE = SFU_PER_SM_CLOCK * SMS * BOOST_CLOCK_HZ
# float32 worker products run three TF32 tensor-core passes per output
TF32_PASSES = 3


def bound_s(flops: float, nbytes: float, peak: float) -> float:
    """The least time the card could take: the larger of operations over
    ``peak`` and bytes over the memory rate."""
    return max(flops / peak, nbytes / PEAK_BYTES)


# ------------------------------------------------------------ coded matmul

def coded_products_s(workers: int, M: int, Z: int, N: int,
                     dtype: str) -> float:
    """Bound of one launch of ``workers`` products ``(M, Z) @ (Z, N)``:
    float32 as three TF32 passes, bf16 at its peak; each operand read once,
    the products written once (bf16 products are written in bf16)."""
    flops = 2.0 * workers * M * Z * N
    elem = 2 if dtype == "bfloat16" else 4
    nbytes = workers * (M * Z + Z * N + M * N) * elem
    if dtype == "bfloat16":
        return bound_s(flops, nbytes, PEAK_FLOPS["bfloat16"])
    return bound_s(TF32_PASSES * flops, nbytes, PEAK_FLOPS["tf32"])


def encode_s(requests: int, N: int, K: int, rows: int, cols: int) -> float:
    """Bound of one float32 encode of a ``(requests, rows, K·cols)`` stack
    into ``(requests, N, rows, cols)`` (the A side; the B side is the
    transpose): the blocks read once, the encoded stack written once."""
    nbytes = 4 * requests * rows * cols * (K + N)
    return nbytes / PEAK_BYTES


# ---------------------------------------------------------------- the LM

def flash_pairs(L: int, window: int) -> int:
    """Unmasked (query, key) pairs of one causal head over ``L`` positions,
    keys within ``window`` of the query (0: no window)."""
    if window <= 0 or window >= L:
        return L * (L + 1) // 2
    # the first ``window`` queries see every earlier key, the rest ``window``
    return window * (window + 1) // 2 + (L - window) * window


def layer_windows(cfg: dict) -> list:
    """Each layer's window (0: full attention)."""
    w = [cfg["sliding_window"]] * cfg["n_layers"]
    for i in cfg.get("global_attn_layers", ()):
        w[i] = 0
    return w


def flash_flops(cfg: dict, B: int, L: int, per_pair: int) -> float:
    """``per_pair``·d FLOP per unmasked pair over every layer and head: 4
    for the forward, 10 for the backward."""
    d, H = cfg["head_dim"], cfg["n_heads"]
    return float(sum(per_pair * d * B * H * flash_pairs(L, w)
                     for w in layer_windows(cfg)))


def lm_forward_flops(cfg: dict, B: int, L: int, head_rows: int) -> float:
    """FLOP of one forward of a hybrid (attention and Mamba) LM over ``B``
    rows of ``L`` tokens: the attention projections and flash's 4·d per
    unmasked pair, the Mamba projections, the gated FFN, and the output
    head over ``head_rows`` positions (the prefill's last position of each
    row, or every position the loss scores)."""
    d, T = cfg["d_model"], B * L
    hd, H, Hkv = cfg["head_dim"], cfg["n_heads"], cfg["n_kv_heads"]
    di, r, S = cfg["d_inner"], cfg["dt_rank"], cfg["ssm_state"]
    per_layer = 2 * T * d * hd * (2 * H + 2 * Hkv)
    per_layer += 2 * T * (d * 2 * di + di * (r + 2 * S) + r * di + di * d)
    per_layer += 2 * T * d * cfg["d_ff"] * 3
    head = 2 * head_rows * d * cfg["padded_vocab"]
    return float(cfg["n_layers"] * per_layer) + flash_flops(cfg, B, L, 4) \
        + head


def scan_fwd_s(Bt: int, L: int, Dm: int, S: int, elem: int = 2) -> float:
    """The scan forward's bound: its exps against its bytes (x, dt, B, C
    read once, y written once; A, D and the final state in float32)."""
    nbytes = elem * (3 * Bt * L * Dm + 2 * Bt * L * S) + 4 * (
        Dm * S + Dm + Bt * Dm * S)
    return max(Bt * L * Dm * S / EXP_RATE, nbytes / PEAK_BYTES)


def scan_bwd_s(Bt: int, L: int, Dm: int, S: int, elem: int = 2,
               chunk: int = 32) -> float:
    """The scan backward's bound: one exp an element against its bytes (x,
    dt, dy, B, C and the forward's float32 state every ``chunk`` steps
    read once; dx, ddt, dB, dC written once)."""
    nbytes = elem * (5 * Bt * L * Dm + 4 * Bt * L * S) + 4 * (
        Bt * -(-L // chunk) * Dm * S + 2 * Dm * S + 2 * Dm)
    return max(Bt * L * Dm * S / EXP_RATE, nbytes / PEAK_BYTES)
