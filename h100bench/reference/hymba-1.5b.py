"""Plain float32 reference of a hybrid decoder LM (hymba: attention and
Mamba heads side by side in every layer, arXiv:2411.13676), its training
loss and gradients, and AdamW, in plain torch with TF32 off.

It follows the configuration file alone and shares no code with the
program: token embedding; per layer ``x + ½(attn(n) + mamba(n))`` with
``n = rmsnorm(x)``, then ``x + swiglu(rmsnorm(x))``; a final norm and an
untied head over the padded vocabulary.  Attention is GQA with rotary
positions (the two halves of each head rotated), causal, within the
layer's window (0: the whole prefix), computed in blocks of queries.  The
Mamba half is in_proj into x and z, a causal depthwise conv and SiLU,
Δ = softplus(dt_proj(x_proj(x)) + bias), B and C from x_proj, the
selective scan h_t = exp(Δ_t A) h_{t−1} + Δ_t x_t B_t, y = C·h + D x,
gated by SiLU(z) and projected out.  The scan runs in chunks: within each
chunk every chunk's state from zero at once, then the states entering
the chunks, then their decay into each step; no step divides by a decay.

Training follows the configuration's stored precision: the update math
runs in float32 and each parameter is stored back in its own dtype, as
the configuration states its parameters (bf16, A_log and D float32).
``mm`` is the products' hook: the controls put lower-precision products
in it.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

F32 = torch.float32
SCAN_CHUNK = 64          # steps a chunk of the scan holds
QUERY_BLOCK = 512        # queries an attention block holds


def leaves(cfg: dict) -> list:
    """``(name, shape, dtype)`` of every parameter, under the names the
    configuration's layout gives them."""
    d, hd = cfg["d_model"], cfg["head_dim"]
    H, Hkv, f = cfg["n_heads"], cfg["n_kv_heads"], cfg["d_ff"]
    di, S, r, c = cfg["d_inner"], cfg["ssm_state"], cfg["dt_rank"], \
        cfg["ssm_conv"]
    dt, Vp = cfg["dtype"], cfg["padded_vocab"]
    out = [("embed", (Vp, d), dt)]
    for i in range(cfg["n_layers"]):
        p = f"layers.{i}."
        out += [(p + "mixer_norm", (d,), dt),
                (p + "attn.wq", (d, H * hd), dt),
                (p + "attn.wk", (d, Hkv * hd), dt),
                (p + "attn.wv", (d, Hkv * hd), dt),
                (p + "attn.wo", (H * hd, d), dt),
                (p + "ssm.in_proj", (d, 2 * di), dt),
                (p + "ssm.conv_w", (c, di), dt),
                (p + "ssm.conv_b", (di,), dt),
                (p + "ssm.x_proj", (di, r + 2 * S), dt),
                (p + "ssm.dt_proj", (r, di), dt),
                (p + "ssm.dt_bias", (di,), dt),
                (p + "ssm.A_log", (di, S), "float32"),
                (p + "ssm.D", (di,), "float32"),
                (p + "ssm.out_proj", (di, d), dt),
                (p + "ffn_norm", (d,), dt),
                (p + "mlp.w_gate", (d, f), dt),
                (p + "mlp.w_up", (d, f), dt),
                (p + "mlp.w_down", (f, d), dt)]
    return out + [("final_norm", (d,), dt), ("lm_head", (d, Vp), dt)]


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32: TF32 off for the duration."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def plain_mm(a, b):
    return a @ b


def fp8_mm(a, b):
    """Products of operands rounded to e4m3 at a per-tensor scale (each
    operand's largest magnitude to 448), summed in float32; gradients pass
    the rounding unchanged."""
    return _fp8(a) @ _fp8(b)


def _fp8(x):
    s = 448.0 / x.detach().abs().amax().clamp_min(1e-30)
    q = (x.detach() * s).to(torch.float8_e4m3fn).to(F32) / s
    return x + (q - x.detach())


# ------------------------------------------------------------------ blocks

def rms(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rope(x, theta):
    """x (B, L, H, hd) at positions 0..L−1."""
    hd, L = x.shape[-1], x.shape[1]
    freqs = theta ** (-torch.arange(0, hd, 2, dtype=F32, device=x.device)
                      / hd)
    ang = torch.arange(L, dtype=F32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, window: int, block: int):
    """Causal GQA over q (B, L, H, hd), k/v (B, L, Hkv, hd) in blocks of
    ``block`` queries, each against the keys its window can reach."""
    B, L, H, hd = q.shape
    Hkv = k.shape[2]
    g = H // Hkv
    qh = q.reshape(B, L, Hkv, g, hd).permute(0, 2, 3, 1, 4)  # B,Hkv,g,L,hd
    kh, vh = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)    # B,Hkv,L,hd
    outs = []
    for q0 in range(0, L, block):
        q1 = min(L, q0 + block)
        k0 = max(0, q0 - window + 1) if window > 0 else 0
        s = torch.einsum("bhgqd,bhkd->bhgqk", qh[:, :, :, q0:q1],
                         kh[:, :, k0:q1]) * hd ** -0.5
        qp = torch.arange(q0, q1, device=q.device)[:, None]
        kp = torch.arange(k0, q1, device=q.device)[None, :]
        ok = kp <= qp
        if window > 0:
            ok = ok & (qp - kp < window)
        s = s.masked_fill(~ok, float("-inf"))
        p = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bhgqk,bhkd->bhgqd", p, vh[:, :, k0:q1]))
    o = torch.cat(outs, dim=3)                                # B,Hkv,g,L,hd
    return o.permute(0, 3, 1, 2, 4).reshape(B, L, H * hd)


def scan(x, dt, A, Bm, Cm, D, chunk: int = 64):
    """y of the selective scan from a zero state.  x, dt (Bt, L, Dm); A
    (Dm, S); Bm, Cm (Bt, L, S); D (Dm,)."""
    Bt, L, Dm = x.shape
    S = A.shape[1]
    pad = (-L) % chunk                # Δ = 0 past the end: state carried
    if pad:
        x, dt, Bm, Cm = (F.pad(t, (0, 0, 0, pad)) for t in (x, dt, Bm, Cm))
    nc = x.shape[1] // chunk
    x4 = x.reshape(Bt, nc, chunk, Dm)
    dt4 = dt.reshape(Bt, nc, chunk, Dm)
    B4 = Bm.reshape(Bt, nc, chunk, S)
    C4 = Cm.reshape(Bt, nc, chunk, S)
    u = dt4 * x4
    h = x.new_zeros((Bt, nc, Dm, S))
    ys = []
    for t in range(chunk):            # every chunk's own states, from zero
        h = torch.exp(dt4[:, :, t, :, None] * A) * h \
            + u[:, :, t, :, None] * B4[:, :, t, None, :]
        ys.append(torch.einsum("bcds,bcs->bcd", h, C4[:, :, t]))
    decay = torch.exp(dt4.sum(2)[..., None] * A)              # Bt,nc,Dm,S
    enter = [x.new_zeros((Bt, Dm, S))]
    for c in range(nc - 1):           # the state entering each chunk
        enter.append(decay[:, c] * enter[-1] + h[:, c])
    Q = torch.stack(enter, 1)
    for t in range(chunk):            # its decay into each step
        Q = Q * torch.exp(dt4[:, :, t, :, None] * A)
        ys[t] = ys[t] + torch.einsum("bcds,bcs->bcd", Q, C4[:, :, t])
    y = torch.stack(ys, 2).reshape(Bt, nc * chunk, Dm)[:, :L]
    return y + D * x[:, :L]


def mamba(p, h, cfg, mm):
    di, S, r = cfg["d_inner"], cfg["ssm_state"], cfg["dt_rank"]
    c = cfg["ssm_conv"]
    xz = mm(h, p["in_proj"])
    xr, z = xz[..., :di], xz[..., di:]
    xp = F.pad(xr, (0, 0, c - 1, 0))
    L = xr.shape[1]
    conv = sum(xp[:, i:i + L] * p["conv_w"][i] for i in range(c)) \
        + p["conv_b"]
    xin = F.silu(conv)
    proj = mm(xin, p["x_proj"])
    dtr, Bm, Cm = proj[..., :r], proj[..., r:r + S], proj[..., r + S:]
    dt = F.softplus(mm(dtr, p["dt_proj"]) + p["dt_bias"])
    y = scan(xin, dt, -torch.exp(p["A_log"]), Bm, Cm, p["D"], SCAN_CHUNK)
    return mm(y * F.silu(z), p["out_proj"])


def layer(p, x, cfg, window: int, mm):
    hd, H, Hkv = cfg["head_dim"], cfg["n_heads"], cfg["n_kv_heads"]
    B, L, _ = x.shape
    n = rms(x, p["mixer_norm"], cfg["norm_eps"])
    q = rope(mm(n, p["wq"]).reshape(B, L, H, hd), cfg["rope_theta"])
    k = rope(mm(n, p["wk"]).reshape(B, L, Hkv, hd), cfg["rope_theta"])
    v = mm(n, p["wv"]).reshape(B, L, Hkv, hd)
    att = mm(attention(q, k, v, window, QUERY_BLOCK), p["wo"])
    x = x + 0.5 * (att + mamba(p, n, cfg, mm))
    n = rms(x, p["ffn_norm"], cfg["norm_eps"])
    f = F.silu(mm(n, p["w_gate"])) * mm(n, p["w_up"])
    return x + mm(f, p["w_down"])


def _layer_params(W, i):
    pre = f"layers.{i}."
    return {k[len(pre):].split(".")[-1]: v for k, v in W.items()
            if k.startswith(pre)}


def windows(cfg) -> list:
    w = [cfg["sliding_window"]] * cfg["n_layers"]
    for i in cfg.get("global_attn_layers", ()):
        w[i] = 0
    return w


def hidden(W, tokens, cfg, mm=plain_mm, remat: bool = False):
    """Final-normed hidden states (B, L, d) in float32 of ``W``'s values."""
    x = W["embed"][tokens]
    for i, win in enumerate(windows(cfg)):
        p = _layer_params(W, i)
        if remat:
            x = checkpoint(layer, p, x, cfg, win, mm, use_reentrant=False)
        else:
            x = layer(p, x, cfg, win, mm)
    return rms(x, W["final_norm"], cfg["norm_eps"])


# ---------------------------------------------------------------- training

def lr_at(step: int, sch: dict) -> float:
    """Cosine with linear warm-up, at step ``step`` (the first update is at
    step 1)."""
    t, peak, warm = float(step), sch["peak_lr"], sch["warmup"]
    if t < warm:
        return peak * t / max(warm, 1)
    prog = min(max((t - warm) / max(sch["total"] - warm, 1), 0.0), 1.0)
    fl = sch["floor_frac"]
    return peak * (fl + (1 - fl) * 0.5 * (1 + math.cos(math.pi * prog)))


def decayed(name: str, shape) -> bool:
    """Weight decay on every per-layer leaf (the layout stacks the layers
    into matrices) and every matrix; not on the final norm."""
    return name.startswith("layers.") or len(shape) >= 2


def train(W, batches, cfg, opt: dict, sch: dict, mm=plain_mm,
          rows: int = 1) -> dict:
    """AdamW steps on ``batches`` from ``W``: each step's mean token loss,
    each leaf's clipped first gradient's norm, and each leaf's change after
    the last step.  Rows of a batch go through in groups of ``rows``, each
    layer recomputed in the backward pass."""
    with no_tf32():
        return _train(W, batches, cfg, opt, sch, mm, rows)


def _train(W, batches, cfg, opt, sch, mm, rows):
    dtypes = {k: v.dtype for k, v in W.items()}
    stored = {k: v.clone() for k, v in W.items()}
    m = {k: torch.zeros(v.shape, dtype=F32, device=v.device)
         for k, v in W.items()}
    vv = {k: torch.zeros_like(t) for k, t in m.items()}
    losses, g1 = [], {}
    b1, b2 = opt["b1"], opt["b2"]
    for s, tokens in enumerate(batches):
        P = {k: v.to(F32).requires_grad_(True) for k, v in stored.items()}
        n_tok = tokens.shape[0] * (tokens.shape[1] - 1)
        loss = 0.0
        for r0 in range(0, tokens.shape[0], rows):
            tk = tokens[r0:r0 + rows]
            h = hidden(P, tk, cfg, mm, remat=True)[:, :-1]
            logits = mm(h.reshape(-1, h.shape[-1]), P["lm_head"])
            ce = torch.logsumexp(logits, -1) - logits.gather(
                -1, tk[:, 1:].reshape(-1, 1))[:, 0]
            part = ce.sum() / n_tok
            part.backward()
            loss += float(part.detach())
            del h, logits, ce, part
        losses.append(loss)
        with torch.no_grad():
            g = {k: p.grad for k, p in P.items()}
            gn = math.sqrt(sum(float((t * t).sum()) for t in g.values()))
            scale = min(1.0, opt["max_grad_norm"] / max(gn, 1e-9))
            t = s + 1
            c1, c2 = 1 - b1 ** t, 1 - b2 ** t
            lr = lr_at(t, sch)
            for k, p in P.items():
                gk = g[k] * scale
                if s == 0:
                    g1[k] = float(torch.linalg.vector_norm(gk))
                m[k].mul_(b1).add_(gk, alpha=1 - b1)
                vv[k].mul_(b2).addcmul_(gk, gk, value=1 - b2)
                upd = (m[k] / c1) / (torch.sqrt(vv[k] / c2) + opt["eps"])
                if decayed(k, p.shape):
                    upd = upd + opt["weight_decay"] * p.detach()
                stored[k] = (p.detach() - lr * upd).to(dtypes[k])
        del P, g
    change = {k: float(torch.linalg.vector_norm(
        stored[k].to(F32) - W[k].to(F32))) for k in W}
    return {"losses": losses, "g1": g1, "change": change}
