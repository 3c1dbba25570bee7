"""Workload graphs: the layer-level DAG DORA compiles (paper §4.1, §5.1).

A *layer* is either a matrix multiplication (``MM``), an MM followed by a
fused non-linear kernel (``MM_NL``), or a standalone non-linear kernel
(``NL`` — the paper's "super-large layer" streamed through DRAM).
Edges are RAW dependencies resolved through off-chip memory (§3.4).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np


class NonLinear(enum.Enum):
    SOFTMAX = "softmax"
    GELU = "gelu"
    LAYERNORM = "layernorm"
    RELU = "relu"
    RELU2 = "relu2"
    SILU = "silu"

    def apply(self, x: np.ndarray) -> np.ndarray:
        x = x.astype(np.float32)
        if self is NonLinear.SOFTMAX:
            m = x.max(axis=-1, keepdims=True)
            e = np.exp(x - m)
            return e / e.sum(axis=-1, keepdims=True)
        if self is NonLinear.GELU:
            return 0.5 * x * (1.0 + np.tanh(
                np.sqrt(2.0 / np.pi) * (x + 0.044715 * x ** 3)))
        if self is NonLinear.LAYERNORM:
            mu = x.mean(axis=-1, keepdims=True)
            var = x.var(axis=-1, keepdims=True)
            return (x - mu) / np.sqrt(var + 1e-5)
        if self is NonLinear.RELU:
            return np.maximum(x, 0.0)
        if self is NonLinear.RELU2:
            r = np.maximum(x, 0.0)
            return r * r
        if self is NonLinear.SILU:
            return x / (1.0 + np.exp(-x))
        raise AssertionError(self)


class LayerKind(enum.Enum):
    MM = "mm"
    MM_NL = "mm_nl"
    NL = "nl"


@dataclass
class Layer:
    """One schedulable node.

    MM layers compute ``OUT[M,N] = LHS[M,K] @ RHS[K,N]`` (+ optional
    fused non-linearity applied row-wise to OUT).
    ``lhs``/``rhs`` name the producing layer (or an external input).
    """

    id: int
    name: str
    kind: LayerKind
    M: int = 0
    K: int = 0
    N: int = 0
    nonlinear: NonLinear | None = None
    lhs: str = ""            # tensor name feeding LHS ("" = external)
    rhs: str = ""            # tensor name feeding RHS (usually a weight)
    deps: tuple[int, ...] = ()   # layer ids this layer RAW-depends on

    @property
    def macs(self) -> int:
        if self.kind is LayerKind.NL:
            return 0
        return self.M * self.K * self.N

    @property
    def flops(self) -> int:
        if self.kind is LayerKind.NL:
            # count ~5 flops/elem for nl kernels
            return 5 * self.M * self.N
        f = 2 * self.macs
        if self.kind is LayerKind.MM_NL:
            f += 5 * self.M * self.N
        return f

    @property
    def out_name(self) -> str:
        return self.name

    def out_shape(self) -> tuple[int, int]:
        return (self.M, self.N)


@dataclass
class WorkloadGraph:
    """A DAG of layers plus its external tensors."""

    name: str
    layers: list[Layer] = field(default_factory=list)
    # external tensors: name -> (rows, cols); weights & inputs
    inputs: dict[str, tuple[int, int]] = field(default_factory=dict)

    # ------------------------------------------------------------------ build
    def add_input(self, name: str, rows: int, cols: int) -> str:
        self.inputs[name] = (rows, cols)
        return name

    def add_mm(self, name: str, lhs: str, rhs: str,
               nonlinear: NonLinear | None = None) -> str:
        m, k = self._shape_of(lhs)
        k2, n = self._shape_of(rhs)
        if k != k2:
            raise ValueError(
                f"{name}: contraction mismatch {lhs}:{(m, k)} @ {rhs}:{(k2, n)}")
        deps = tuple(sorted({lid for lid in (self._producer(lhs),
                                             self._producer(rhs))
                             if lid is not None}))
        kind = LayerKind.MM_NL if nonlinear else LayerKind.MM
        self.layers.append(Layer(len(self.layers), name, kind, m, k, n,
                                 nonlinear, lhs, rhs, deps))
        return name

    def add_nl(self, name: str, src: str, nonlinear: NonLinear) -> str:
        m, n = self._shape_of(src)
        dep = self._producer(src)
        self.layers.append(Layer(
            len(self.layers), name, LayerKind.NL, m, 0, n, nonlinear,
            lhs=src, deps=(dep,) if dep is not None else ()))
        return name

    def _shape_of(self, name: str) -> tuple[int, int]:
        if name in self.inputs:
            return self.inputs[name]
        for l in self.layers:
            if l.name == name:
                return l.out_shape()
        raise KeyError(f"unknown tensor {name!r} in {self.name}")

    def _producer(self, name: str) -> int | None:
        for l in self.layers:
            if l.name == name:
                return l.id
        return None

    # -------------------------------------------------------------- analysis
    def validate(self) -> None:
        ids = {l.id for l in self.layers}
        if ids != set(range(len(self.layers))):
            raise ValueError("layer ids must be 0..n-1")
        for l in self.layers:
            for d in l.deps:
                if d >= l.id:
                    raise ValueError(f"layer {l.id} depends on later layer {d}"
                                     " (graph must be topologically indexed)")

    def topo_order(self) -> list[Layer]:
        return sorted(self.layers, key=lambda l: l.id)

    def successors(self) -> dict[int, list[int]]:
        succ: dict[int, list[int]] = {l.id: [] for l in self.layers}
        for l in self.layers:
            for d in l.deps:
                succ[d].append(l.id)
        return succ

    @property
    def total_macs(self) -> int:
        return sum(l.macs for l in self.layers)

    @property
    def total_flops(self) -> int:
        return sum(l.flops for l in self.layers)

    def critical_path(self, latency: dict[int, float]) -> float:
        """Longest path through the DAG under per-layer latencies."""
        finish: dict[int, float] = {}
        for l in self.topo_order():
            start = max((finish[d] for d in l.deps), default=0.0)
            finish[l.id] = start + latency[l.id]
        return max(finish.values(), default=0.0)

    # ------------------------------------------------------------- reference
    def reference_execute(self, tensors: dict[str, np.ndarray]
                          ) -> dict[str, np.ndarray]:
        """Numpy oracle: execute the DAG directly. ``tensors`` must hold
        every external input; returns all layer outputs by name."""
        env = dict(tensors)
        for name, (r, c) in self.inputs.items():
            if name not in env:
                raise KeyError(f"missing external input {name!r}")
            if env[name].shape != (r, c):
                raise ValueError(f"{name}: expected {(r, c)}, "
                                 f"got {env[name].shape}")
        for l in self.topo_order():
            if l.kind is LayerKind.NL:
                env[l.name] = l.nonlinear.apply(env[l.lhs])
            else:
                out = env[l.lhs].astype(np.float32) @ env[l.rhs].astype(np.float32)
                if l.nonlinear is not None:
                    out = l.nonlinear.apply(out)
                env[l.name] = out
        return env

    def namespaced_copy(self, prefix: str, sep: str = "::") -> "WorkloadGraph":
        """A copy with every tensor/layer name prefixed ``prefix::name``
        — the multi-tenant merge uses this so N tenants' tensors never
        collide in the joint DRAM memory map."""
        def nm(n: str) -> str:
            return f"{prefix}{sep}{n}" if n else n

        g = WorkloadGraph(nm(self.name))
        g.inputs = {nm(k): v for k, v in self.inputs.items()}
        g.layers = [Layer(l.id, nm(l.name), l.kind, l.M, l.K, l.N,
                          l.nonlinear, nm(l.lhs), nm(l.rhs), l.deps)
                    for l in self.layers]
        return g

    def random_inputs(self, seed: int = 0) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(seed)
        return {name: rng.normal(size=shape, scale=0.5).astype(np.float32)
                for name, shape in self.inputs.items()}


# --------------------------------------------------------------------------
# Builders for common blocks (used by configs/paper_models.py)
# --------------------------------------------------------------------------

def mlp_graph(name: str, batch: int, dims: list[int],
              nonlinear: NonLinear = NonLinear.RELU) -> WorkloadGraph:
    """An MLP: batch x dims[0] -> ... -> dims[-1], NL between layers."""
    g = WorkloadGraph(name)
    x = g.add_input("x", batch, dims[0])
    for i in range(len(dims) - 1):
        w = g.add_input(f"w{i}", dims[i], dims[i + 1])
        nl = nonlinear if i < len(dims) - 2 else None
        x = g.add_mm(f"fc{i}", x, w, nl)
    return g


def transformer_block_graph(g: WorkloadGraph, prefix: str, x: str,
                            seq: int, d_model: int, n_heads: int,
                            d_ff: int) -> str:
    """One encoder block as MM/NL layers (per-head attention folded into
    head-batched MMs the way DORA maps them: QK^T and PV as MMs with the
    head dim folded into K/N)."""
    wq = g.add_input(f"{prefix}.wq", d_model, d_model)
    wk = g.add_input(f"{prefix}.wk", d_model, d_model)
    wv = g.add_input(f"{prefix}.wv", d_model, d_model)
    wo = g.add_input(f"{prefix}.wo", d_model, d_model)
    q = g.add_mm(f"{prefix}.q", x, wq)
    k = g.add_mm(f"{prefix}.k", x, wk)
    v = g.add_mm(f"{prefix}.v", x, wv)
    # scores: (seq x d_model) @ (d_model x seq) proxy for head-batched QK^T
    kt = g.add_input(f"{prefix}.kT", d_model, seq)   # transposed stream of k
    s = g.add_mm(f"{prefix}.scores", q, kt, NonLinear.SOFTMAX)
    vv = g.add_input(f"{prefix}.vS", seq, d_model)   # v in (seq, d_model)
    o = g.add_mm(f"{prefix}.attn_out", s, vv)
    o = g.add_mm(f"{prefix}.proj", o, wo, NonLinear.LAYERNORM)
    w1 = g.add_input(f"{prefix}.w1", d_model, d_ff)
    w2 = g.add_input(f"{prefix}.w2", d_ff, d_model)
    h = g.add_mm(f"{prefix}.ffn1", o, w1, NonLinear.GELU)
    h = g.add_mm(f"{prefix}.ffn2", h, w2, NonLinear.LAYERNORM)
    return h


def random_dag(n_layers: int, seed: int = 0, max_dim: int = 512,
               p_edge: float = 0.3) -> WorkloadGraph:
    """Random well-formed workload DAGs for property tests."""
    rng = np.random.default_rng(seed)
    g = WorkloadGraph(f"random{seed}")
    names: list[str] = []
    dims = [8, 16, 24, 32, 48, 64, 96, 128, 192, 256, 384, max_dim]
    for i in range(n_layers):
        m, k, n = (int(rng.choice(dims)) for _ in range(3))
        # choose lhs from a previous layer output (if shape-compatible
        # by construction we instead add fresh inputs; edges via deps)
        lhs = g.add_input(f"in{i}", m, k)
        rhs = g.add_input(f"w{i}", k, n)
        nl = rng.choice([None, NonLinear.GELU, NonLinear.SOFTMAX])
        name = g.add_mm(f"l{i}", lhs, rhs, nl)
        names.append(name)
        # random extra deps to earlier layers
        extra = tuple(int(j) for j in range(i) if rng.random() < p_edge)
        lay = g.layers[-1]
        lay.deps = tuple(sorted(set(lay.deps) | set(extra)))
    g.validate()
    return g
