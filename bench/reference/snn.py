"""Plain reference of the emulated multi-chip network, built from a
configuration file under ``bench/configs/``.

Plain PyTorch, written from the paper's semantics as the configuration
states them; it imports nothing of the program under test and takes
nothing the program made: the benchmark hands it the same seeded weights,
drives and stimuli it hands the program, and the program's outputs, which
it only judges.

* ``Fabric.route`` — one exchange round of the configured hop graph for a
  batch of independent streams: egress frame (the first ``capacity``
  spikes of a chip in neuron order), forward LUT (identity over the
  15-bit wire label space: labels at or past 2^15 carry no enable),
  leaf-uplink pack, per level the children's streams gated by the route
  enables (all routes enabled, no self loop at level 0, own subtree
  excluded above it) and the cascaded uplink packs, the destination's
  nearest-first merge packed to its ingress capacity, the reverse LUT and
  the feed-forward row map (neuron ``k`` of chip ``i`` drives row
  ``k mod rows`` of chip ``i + 1``).  On the timed lane every event
  carries its wire latency in integer ns: the sender's fixed path, each
  lane's wait of the event's rank, each crossing's extra above level 0,
  the destination queue's wait of its output slot and the receiver's
  fixed path.
* ``dense_route`` — the same routing without a wire: every spike of chip
  ``i`` reaches chip ``i + 1``.
* ``follow`` — the neurons, and per-session plasticity, driven by the
  program's own spike raster (teacher forcing): every step's drive is the
  external drive plus the reference's routing of the program's spikes of
  ``delay`` steps before, the membrane integrates in float64, and every
  step the reference's threshold decision is held against the program's
  spike.  A disagreement is a fault unless the membrane lay within
  rounding of the threshold: the widest such distance is the number
  compared (``Follow.spike_gap``).  The program's spike then resets the
  neuron, so one disagreement does not cascade.
* ``stream`` — the free-running closed loop, the reference put in the
  program's place: the lower-precision control of the correctness check.
"""

from __future__ import annotations

import dataclasses
import math

import torch

NEURON_BITS = 9


def _f32(x: float) -> float:
    """``x`` rounded to float32, as a Python float."""
    return float(torch.tensor(x, dtype=torch.float32))


def queue_wait(rank: torch.Tensor, service: int, cc: int, stall: int
               ) -> torch.Tensor:
    """Wait of 0-based arrival rank ``rank`` at one server in integer ns:
    ``rank·service + ⌊rank / cc⌋·stall``."""
    wait = rank * service
    if cc:
        wait = wait + torch.div(rank, cc, rounding_mode="floor") * stall
    return wait


def excl_rank(valid: torch.Tensor) -> torch.Tensor:
    """Exclusive rank of every valid slot among the valid slots before it
    on the last axis (int64)."""
    ok = valid.long()
    return torch.cumsum(ok, dim=-1) - ok


def compact(valid: torch.Tensor, cap: int, *payloads: torch.Tensor):
    """Pack the valid slots of every stream (the last axis) to the front of
    ``cap`` slots in arrival order; the rest are dropped.  Returns
    ``(valid, payloads, dropped)``; empty slots hold 0."""
    pos = excl_rank(valid)
    keep = valid & (pos < cap)
    idx = torch.where(keep, pos, cap)
    shape = (*valid.shape[:-1], cap + 1)
    out_v = torch.zeros(shape, dtype=torch.bool, device=valid.device)
    out_v.scatter_(-1, idx, keep)
    outs = []
    for p in payloads:
        o = torch.zeros(shape, dtype=p.dtype, device=p.device)
        o.scatter_(-1, idx, torch.where(keep, p, torch.zeros_like(p)))
        outs.append(o[..., :cap])
    dropped = valid.sum(-1) - keep.sum(-1)
    return out_v[..., :cap], outs, dropped


@dataclasses.dataclass(frozen=True)
class Wire:
    """Integer-ns constants of the timed lane (the configuration's
    ``timed_wire``)."""

    sender_fixed_ns: int
    recv_fixed_ns: int
    second_layer_extra_ns: int
    service_ns: int
    cc_interval: int
    cc_stall_ns: int
    n_stall_hops: int


class Fabric:
    """The configured hop graph (``fan_ins`` leaf level first,
    ``link_capacities`` per level, ingress ``capacity``)."""

    def __init__(self, config: dict):
        self.fan_ins = tuple(int(f) for f in config["fan_ins"])
        self.caps = tuple(None if c is None else int(c)
                          for c in config["link_capacities"])
        self.capacity = int(config["capacity"])
        self.n = math.prod(self.fan_ins)
        self.neurons = int(config["chip"]["neurons"])
        self.rows = int(config["chip"]["synapse_rows"])
        self.label_limit = 1 << int(config["wire_label_bits"])
        self.wire = Wire(**config["timed_wire"])
        if self.n != int(config["chips"]) or len(self.caps) != len(
                self.fan_ins):
            raise ValueError("fan_ins, link_capacities and chips disagree")

    def route(self, spikes: torch.Tensor, timed: bool = False):
        """One exchange round of every stream.

        ``spikes``: bool[B, n, neurons], B independent streams.  Returns a
        dict: ``drive`` f32[B, n, rows] (the ingress rows' event counts),
        ``dropped`` (egress + congestion) and ``uplink`` int64[B, n], and
        on the timed lane ``lat`` int64[B, n, capacity] with ``lat_valid``
        bool[B, n, capacity].
        """
        w = self.wire
        up_q = (w.service_ns, w.cc_interval, w.cc_stall_ns)
        B, n, K = spikes.shape
        dev = spikes.device
        chips = torch.arange(n, device=dev)
        label = (chips[:, None] << NEURON_BITS) + torch.arange(K, device=dev)
        valid, (lab,), egress_drop = compact(spikes, self.capacity,
                                             label.expand(B, n, K))
        ev = valid & (lab < self.label_limit)          # forward LUT enable
        t = None
        if timed:
            t = w.sender_fixed_ns + queue_wait(excl_rank(ev), *up_q)
            t = torch.where(ev, t, 0)
        uplink = torch.zeros((B, n), dtype=torch.long, device=dev)
        if self.caps[0] is not None:
            ev, packed, drop = compact(ev, self.caps[0], lab,
                                       *(() if t is None else (t,)))
            lab = packed[0]
            t = packed[1] if timed else None
            uplink = uplink + drop
        leaf = torch.arange(n, device=dev)
        cur_l, cur_v, cur_t = lab, ev, t           # [B, n_ent, L]
        g = 1                                      # leaves per entity
        parts_l, parts_v, parts_t = [], [], []
        for i, f in enumerate(self.fan_ins):
            L = cur_l.shape[-1]
            n_grp = n // (g * f)
            anc = leaf // (g * f)                  # each leaf's ancestor
            child = (leaf // g) % f                # ... and its child slot
            gate = torch.arange(f, device=dev)[None, :] != child[:, None]
            parts_l.append(cur_l.reshape(B, n_grp, f * L)[:, anc])
            pv = cur_v.reshape(B, n_grp, f, L)[:, anc] & gate[None, :, :,
                                                               None]
            parts_v.append(pv.reshape(B, n, f * L))
            if timed:
                parts_t.append(cur_t.reshape(B, n_grp, f * L)[:, anc])
            if i + 1 < len(self.fan_ins):
                s_l = cur_l.reshape(B, n_grp, f * L)
                s_v = cur_v.reshape(B, n_grp, f * L)
                s_t = None
                if timed:
                    s_t = (cur_t.reshape(B, n_grp, f * L)
                           + w.second_layer_extra_ns
                           + queue_wait(excl_rank(s_v), *up_q))
                    s_t = torch.where(s_v, s_t, 0)
                cap = self.caps[i + 1]
                if cap is not None:
                    s_v, packed, drop = compact(
                        s_v, cap, s_l, *(() if s_t is None else (s_t,)))
                    s_l = packed[0]
                    s_t = packed[1] if timed else None
                    uplink = uplink + drop[:, leaf // (g * f)]
                cur_l, cur_v, cur_t = s_l, s_v, s_t
                g *= f
        m_v, packed, congestion = compact(
            torch.cat(parts_v, -1), self.capacity, torch.cat(parts_l, -1),
            *((torch.cat(parts_t, -1),) if timed else ()))
        m_l = packed[0]
        out = {"dropped": egress_drop + congestion, "uplink": uplink}
        if timed:
            slot = torch.arange(self.capacity, device=dev)
            q = queue_wait(slot, w.service_ns, w.cc_interval,
                           w.cc_stall_ns * w.n_stall_hops)
            out["lat"] = torch.where(m_v, packed[1] + q + w.recv_fixed_ns, 0)
            out["lat_valid"] = m_v
        # Reverse LUT (identity) and the feed-forward row map.
        src = m_l >> NEURON_BITS
        ok = m_v & (src == leaf[None, :, None] - 1)
        row = torch.where(ok, (m_l & ((1 << NEURON_BITS) - 1)) % self.rows,
                          self.rows)
        drive = torch.zeros((B, n, self.rows + 1), dtype=torch.float32,
                            device=dev)
        drive.scatter_add_(-1, row, ok.float())
        out["drive"] = drive[..., :self.rows]
        return out

    def dense_route(self, spikes: torch.Tensor) -> torch.Tensor:
        """Dense routing of ``spikes`` bool[B, n, neurons]: chip ``i``'s
        neuron ``k`` drives row ``k mod rows`` of chip ``i + 1`` wherever
        its label has a forward enable; no capacity, no drops."""
        B, n, K = spikes.shape
        s = spikes.float()
        src_ok = ((torch.arange(n, device=spikes.device) << NEURON_BITS)
                  + K - 1) < self.label_limit
        s = s * src_ok[None, :, None]
        per_row = s.reshape(B, n, K // self.rows, self.rows).sum(2)
        drive = torch.zeros((B, n, self.rows), dtype=torch.float32,
                            device=spikes.device)
        drive[:, 1:] = per_row[:, :-1]
        return drive


# ---------------------------------------------------------------------------
# Neurons, synapses and plasticity
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Neuron:
    """AdEx/LIF constants (the configuration's ``neuron``), stepped by
    exponential Euler."""

    tau_mem_us: float
    tau_syn_us: float
    tau_adapt_us: float
    v_leak: float
    v_th: float
    v_reset: float
    v_exp: float
    delta_t: float
    adapt_a: float
    adapt_b: float
    refrac_us: float
    dt_us: float

    @property
    def a_mem(self) -> float:
        return math.exp(-self.dt_us / self.tau_mem_us)

    @property
    def a_syn(self) -> float:
        return math.exp(-self.dt_us / self.tau_syn_us)

    @property
    def a_adapt(self) -> float:
        return math.exp(-self.dt_us / self.tau_adapt_us)

    @property
    def refrac_steps(self) -> int:
        return int(round(self.refrac_us / self.dt_us))


def init_neurons(shape, p: Neuron, dtype, device) -> dict:
    return {"v": torch.full(shape, p.v_leak, dtype=dtype, device=device),
            "i_syn": torch.zeros(shape, dtype=dtype, device=device),
            "w_adapt": torch.zeros(shape, dtype=dtype, device=device),
            "refrac": torch.zeros(shape, dtype=torch.long, device=device)}


def membrane(st: dict, current: torch.Tensor, p: Neuron):
    """The membrane before the threshold: (i_syn, v)."""
    i_syn = current + p.a_syn * st["i_syn"]
    dv = (1.0 - p.a_mem) * (p.v_leak - st["v"])
    if p.delta_t > 0.0:
        arg = torch.clamp((st["v"] - p.v_exp) / p.delta_t, -20.0, 20.0)
        dv = dv + (1.0 - p.a_mem) * p.delta_t * torch.exp(arg)
    dv = dv + (1.0 - p.a_mem) * (i_syn - st["w_adapt"])
    v = torch.where(st["refrac"] > 0, p.v_reset, st["v"] + dv)
    return i_syn, v


def settle(st: dict, i_syn, v, spikes: torch.Tensor, p: Neuron) -> dict:
    """Reset, adaptation and refractory countdown after ``spikes``."""
    s = spikes.to(v.dtype)
    return {"v": (1.0 - s) * v + s * p.v_reset,
            "i_syn": i_syn,
            "w_adapt": (p.a_adapt * st["w_adapt"]
                        + (1.0 - p.a_adapt) * p.adapt_a
                        * (st["v"] - p.v_leak) + s * p.adapt_b),
            "refrac": torch.where(spikes, p.refrac_steps,
                                  torch.clamp(st["refrac"] - 1, min=0))}


def effective_weights(w, w_scale, row_sign, wmax: int, dtype):
    """Quantised 6-bit weights times the chip's scale and row sign:
    shared ``w`` [c, rows, n] or per session [c, b, rows, n]."""
    q = torch.round(torch.clamp(w.to(dtype), 0.0, float(wmax)))
    scale = w_scale.to(dtype)
    sign = row_sign.to(dtype)
    if w.dim() == 4:
        return q * scale[:, None, None, None] * sign[:, None, :, None]
    return q * scale[:, None, None] * sign[:, :, None]


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10-bit mantissa, to nearest even."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def synapse_current(drive, w_eff, precision: str = "float64"):
    """``drive`` [c, b, rows] against ``w_eff`` [c, rows, n] (shared) or
    [c, b, rows, n] (per session).  ``"tf32"`` rounds both operands to
    TF32 and accumulates in float32."""
    if precision == "tf32":
        drive, w_eff = tf32(drive.float()), tf32(w_eff.float())
    else:
        drive = drive.to(w_eff.dtype)
    if w_eff.dim() == 3:
        return torch.bmm(drive, w_eff)
    c, b, r, n = w_eff.shape
    return torch.bmm(drive.reshape(c * b, 1, r),
                     w_eff.reshape(c * b, r, n)).reshape(c, b, n)


@dataclasses.dataclass(frozen=True)
class STDP:
    tau_pre_us: float
    tau_post_us: float
    lr_pot: float
    lr_dep: float
    dt_us: float


def _fma(a: float, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a·b + c`` rounded once to float32 (a fused multiply-add): exact in
    float64 for float32 operands, then rounded."""
    return torch.add(c.double(), b.double(), alpha=_f32(a)).float()


def stdp_step(tr_pre, tr_post, w, pre, post, cfg: STDP, wmax: int,
              precision: str = "float32"):
    """One per-session STDP step: traces filter pre (the row drive) and
    post (the spikes); pre-before-post potentiates, post-before-pre
    depresses; ``clip(w + (lr_pot·E1 − lr_dep·E2)·wmax, 0, wmax)``.  The
    configured datapath is float32 with every multiply feeding an add
    fused (rounded once); ``"bfloat16"`` computes it all in bfloat16."""
    a_pre = math.exp(-cfg.dt_us / cfg.tau_pre_us)
    a_post = math.exp(-cfg.dt_us / cfg.tau_post_us)
    if precision == "bfloat16":
        bf = torch.bfloat16
        tr_pre = a_pre * tr_pre.to(bf) + pre.to(bf)
        tr_post = a_post * tr_post.to(bf) + post.to(bf)
        dw = (cfg.lr_pot * tr_pre[..., :, None] * post.to(bf)[..., None, :]
              - cfg.lr_dep * pre.to(bf)[..., :, None]
              * tr_post[..., None, :])
        w = torch.clamp(w.to(bf) + dw * wmax, 0.0, float(wmax))
        return tr_pre.float(), tr_post.float(), w.float()
    tr_pre = _fma(a_pre, tr_pre, pre)
    tr_post = _fma(a_post, tr_post, post)
    e1 = tr_pre[..., :, None] * post[..., None, :]
    e2 = pre[..., :, None] * tr_post[..., None, :]
    dw = _fma(cfg.lr_pot, e1, -(e2 * _f32(cfg.lr_dep)))
    w = torch.clamp(_fma(float(wmax), dw, w), 0.0, float(wmax))
    return tr_pre, tr_post, w


# ---------------------------------------------------------------------------
# The network
# ---------------------------------------------------------------------------


class Net:
    """The configured network with the benchmark's seeded parameters:
    ``weights`` f32[n, rows, neurons], ``row_sign`` f32[n, rows] (±1),
    ``w_scale`` f32[n]."""

    def __init__(self, config: dict, weights, row_sign, w_scale):
        self.fabric = Fabric(config)
        self.neuron = Neuron(**config["neuron"])
        self.delay = int(config["delay_steps"])
        self.wmax = (1 << int(config["chip"]["weight_bits"])) - 1
        self.weights, self.row_sign, self.w_scale = weights, row_sign, w_scale

    def w_eff(self, w=None, dtype=torch.float64):
        return effective_weights(self.weights if w is None else w,
                                 self.w_scale, self.row_sign, self.wmax,
                                 dtype)

    def routed(self, spikes, mode: str, timed: bool):
        """Route ``spikes`` bool[B, n, neurons]: the fabric's dict; in
        dense mode the drive and zero drop counts."""
        if mode == "dense":
            zeros = torch.zeros(spikes.shape[:2], dtype=torch.long,
                                device=spikes.device)
            return {"drive": self.fabric.dense_route(spikes),
                    "dropped": zeros, "uplink": zeros}
        return self.fabric.route(spikes, timed)


@dataclasses.dataclass
class Follow:
    """What ``follow`` found: the widest distance from threshold of a
    disagreeing spike (0 when none disagrees), how many disagreed, the
    reference's routing outputs per step and its final state."""

    spike_gap: float
    disagreements: int
    routed: dict
    state: dict
    plasticity: tuple | None = None


def follow(net: Net, n_steps: int, raster, ext, *, mode: str = "event",
           timed: bool = False, stdp: STDP | None = None,
           chunk: int = 64) -> Follow:
    """Teacher-forced reference over a spike raster of the program.

    ``raster(t0, t1)``: the program's spikes of steps ``t0:t1``,
    bool[t1 - t0, n, R, neurons], of ``n_steps`` consecutive steps of R
    independent rows from rest (zero state, empty delay line);
    ``ext(t0, t1)``: the external drives of the same steps, f32[t1 - t0,
    n, R, rows].  ``stdp``: per-row plasticity from the network's weights
    (every row its own copy).  Routing runs batched over ``chunk`` steps;
    the neurons step one at a time in float64.  ``Follow.routed`` holds
    per-step outputs ``[N, n, R]`` (``dropped``, ``uplink``, and timed
    ``lat_sum``, ``lat_n``; the full ``lat``/``lat_valid`` planes
    ``[N, n, R, capacity]`` too when R == 1).
    """
    N = n_steps
    first = raster(0, min(N, chunk))
    _, n, R, K = first.shape
    dev = first.device
    p = net.neuron
    st = init_neurons((n, R, K), p, torch.float64, dev)
    plast = None
    if stdp is not None:
        w0 = net.weights.float()
        plast = (torch.zeros((n, R, net.fabric.rows), device=dev),
                 torch.zeros((n, R, K), device=dev),
                 w0[:, None].expand(n, R, *w0.shape[1:]).clone())
    else:
        w_eff = net.w_eff()
    pending = [torch.zeros((n, R, net.fabric.rows), device=dev)
               for _ in range(net.delay)]
    outs = {}
    gap, count = 0.0, 0
    for t0 in range(0, N, chunk):
        t1 = min(N, t0 + chunk)
        T = t1 - t0
        spikes = first if t0 == 0 else raster(t0, t1)
        flat = spikes.permute(0, 2, 1, 3).reshape(T * R, n, K)
        r = net.routed(flat, mode, timed)
        routed_drive = r["drive"].reshape(T, R, n, -1).permute(0, 2, 1, 3)
        for k, v in r.items():
            if k == "drive":
                continue
            v = v.reshape(T, R, n, *v.shape[2:]).transpose(1, 2)
            if k == "lat":
                outs.setdefault("lat_sum", []).append(v.sum(-1))
                outs.setdefault("lat_n", []).append(
                    r["lat_valid"].reshape(T, R, n, -1).transpose(1, 2)
                    .sum(-1))
                if R != 1:
                    continue
            elif k == "lat_valid" and R != 1:
                continue
            outs.setdefault(k, []).append(v)
        drives = ext(t0, t1)
        for j in range(T):
            drive = drives[j] + pending[(t0 + j) % net.delay]
            if plast is None:
                current = synapse_current(drive, w_eff)
            else:
                current = synapse_current(drive,
                                          net.w_eff(plast[2], torch.float64))
            i_syn, v = membrane(st, current, p)
            fire = (v - p.v_th > 0) & ~(st["refrac"] > 0)
            s = spikes[j]
            bad = fire != s
            if bool(bad.any()):
                count += int(bad.sum())
                gap = max(gap, float((v - p.v_th).abs()[bad].max()))
            st = settle(st, i_syn, v, s, p)
            if plast is not None:
                plast = stdp_step(*plast, drive, s.float(), stdp, net.wmax)
            pending[(t0 + j) % net.delay] = routed_drive[j]
    routed = {k: torch.cat(v) for k, v in outs.items()}
    st["inflight"] = torch.stack([pending[(N + k) % net.delay]
                                  for k in range(net.delay)])
    return Follow(spike_gap=gap, disagreements=count, routed=routed,
                  state=st, plasticity=plast)


def stream(net: Net, state: dict, drives: torch.Tensor, *,
           mode: str = "event", timed: bool = False,
           stdp: STDP | None = None, plast=None, slot_mask=None,
           precision: str = "tf32", plast_precision: str = "bfloat16"):
    """The free-running closed loop in ``precision`` (the control): the
    synapse product in TF32, the neurons in float32, per-row plasticity
    in ``plast_precision``.

    ``state``: ``init_state``'s dict or a previous call's; ``drives``:
    f32[T, n, B, rows].  ``plast``: (trace_pre, trace_post, weights
    [n, B, rows, neurons]) with ``stdp``.  ``slot_mask`` bool[T, B]
    silences rows (their spikes are zeroed and their plasticity frozen).
    Returns (outputs dict of ``[T, n, B, ...]`` tensors, state, plast).
    """
    p = net.neuron
    T, n, B, _ = drives.shape
    st = {k: v for k, v in state.items() if k != "inflight"}
    ring = list(state["inflight"])
    w_eff = None if plast is not None else net.w_eff(dtype=torch.float32)
    rec = {"spikes": [], "dropped": [], "uplink": [], "lat": [],
           "lat_valid": []}
    for t in range(T):
        slot = t % net.delay
        drive = drives[t] + ring[slot]
        w = w_eff if plast is None else net.w_eff(plast[2], torch.float32)
        current = synapse_current(drive, w, precision).float()
        i_syn, v = membrane(st, current, p)
        fire = (v - p.v_th > 0) & ~(st["refrac"] > 0)
        # The neurons reset on every spike; a silenced row emits none.
        st = settle(st, i_syn, v, fire, p)
        if slot_mask is not None:
            fire = fire & slot_mask[t][None, :, None]
        if plast is not None:
            new = stdp_step(*plast, drive, fire.float(), stdp, net.wmax,
                            plast_precision)
            if slot_mask is not None:
                keep = slot_mask[t][None, :, None]
                new = tuple(torch.where(keep if x.dim() == 3
                                        else keep[..., None], x, old)
                            for x, old in zip(new, plast))
            plast = new
        r = net.routed(fire.transpose(0, 1), mode, timed)
        ring[slot] = r["drive"].transpose(0, 1)
        rec["spikes"].append(fire)
        for k in ("dropped", "uplink"):
            rec[k].append(r[k].transpose(0, 1).int())
        if timed:
            rec["lat"].append(r["lat"].transpose(0, 1).int())
            rec["lat_valid"].append(r["lat_valid"].transpose(0, 1))
    out = {k: torch.stack(v) for k, v in rec.items() if v}
    out["spikes"] = out["spikes"].float()
    if net.delay > 1 and T % net.delay:
        shift = T % net.delay
        ring = ring[shift:] + ring[:shift]
    st["inflight"] = torch.stack(ring)
    return out, st, plast


def init_state(net: Net, batch: int, device) -> dict:
    """Rest state of every chip for ``batch`` rows and an empty delay
    line, as the float32 closed loop keeps it."""
    n, K = net.fabric.n, net.fabric.neurons
    st = init_neurons((n, batch, K), net.neuron, torch.float32, device)
    st["inflight"] = torch.zeros((net.delay, n, batch, net.fabric.rows),
                                 device=device)
    return st
