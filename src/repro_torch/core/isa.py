"""DORA instruction set architecture (paper Table 1), byte-exact.

Every instruction is a fixed-width 32-bit *header* followed by a
variable-width, unit-specific *body*:

  header (32 bits) = is_last(1) | unit_kind(3) | unit_index(8) |
                     op_type(8)  | valid_length(12)

``valid_length`` is the body length in bytes, so the IDU can fetch the
header, decode ``des_unit = (unit_kind, unit_index)`` and forward exactly
``valid_length`` following bytes without understanding them.

Field widths (this repo's concrete encoding of the paper's Table 1 —
the paper leaves body widths unit-specific):

  u8  : unit indices, buffer selectors, flags, op sub-codes
  u16 : layer ids, repeat counts, element counts
  u32 : DRAM addresses, row/col ranges, loop bounds (paper uses u16 on
        VCK190; we widen bounds/ranges to u32 so the same ISA addresses
        LM-scale operands — documented deviation)

All encode/decode paths are exercised by hypothesis round-trip tests.
"""

from __future__ import annotations

import enum
import struct
from dataclasses import dataclass, field
from typing import ClassVar, Iterator


class UnitKind(enum.IntEnum):
    IDU = 0
    MIU = 1
    SFU = 2
    LMU = 3
    MMU = 4


class OpType(enum.IntEnum):
    # MIU
    MIU_LOAD = 1        # DRAM -> LMU
    MIU_STORE = 2       # LMU -> DRAM (emits ready signal for its layer)
    # SFU
    SFU_SOFTMAX = 3
    SFU_GELU = 4
    SFU_LAYERNORM = 5
    SFU_RELU = 6
    SFU_RELU2 = 7       # squared ReLU (nemotron)
    SFU_SILU = 8
    # LMU
    LMU_CFG = 9         # role / logical-composition configuration
    LMU_MOVE = 10       # forward a tile over the streaming network
    # MMU
    MMU_GEMM = 11
    # IDU pseudo-op (header-only stream terminator)
    IDU_HALT = 12


class LmuRole(enum.IntEnum):
    LHS = 0
    RHS = 1
    OUT = 2
    NL = 3   # non-linear staging buffer


class Epilogue(enum.IntEnum):
    NONE = 0
    BIAS = 1
    GELU = 2
    RELU = 3
    RELU2 = 4
    SILU = 5


_WIDTH_FMT = {1: "B", 2: "H", 4: "I"}


@dataclass(frozen=True)
class _F:
    name: str
    nbytes: int  # 1, 2 or 4


class Body:
    """Base class: subclasses declare FIELDS; pack/unpack are generic."""

    FIELDS: ClassVar[tuple[_F, ...]] = ()
    OP_TYPES: ClassVar[tuple[OpType, ...]] = ()

    def pack(self) -> bytes:
        out = bytearray()
        for f in self.FIELDS:
            v = int(getattr(self, f.name))
            if v < 0 or v >= (1 << (8 * f.nbytes)):
                raise ValueError(f"{type(self).__name__}.{f.name}={v} "
                                 f"out of range for u{8 * f.nbytes}")
            out += struct.pack("<" + _WIDTH_FMT[f.nbytes], v)
        out += self._pack_tail()
        return bytes(out)

    def _pack_tail(self) -> bytes:
        return b""

    @classmethod
    def unpack(cls, raw: bytes):
        vals, off = {}, 0
        for f in cls.FIELDS:
            (v,) = struct.unpack_from("<" + _WIDTH_FMT[f.nbytes], raw, off)
            vals[f.name] = v
            off += f.nbytes
        obj = cls(**vals, **cls._unpack_tail(raw, off))
        return obj

    @classmethod
    def _unpack_tail(cls, raw: bytes, off: int) -> dict:
        if off != len(raw):
            raise ValueError(f"{cls.__name__}: {len(raw) - off} trailing bytes")
        return {}


@dataclass
class MIUBody(Body):
    """Off-chip <-> on-chip tile move. STORE emits a ready signal for
    ``layer_id``; LOAD blocks until every layer in ``deps`` is ready
    (the Sync Unit's Ready List Table, paper §3.4)."""

    ddr_addr: int          # u32 byte address of the DRAM tensor base
    src_lmu: int           # u8 (STORE source; 0 for LOAD)
    des_lmu: int           # u8 (LOAD destination; 0 for STORE)
    M: int                 # u32 full tensor rows
    N: int                 # u32 full tensor cols
    start_row: int         # u32 tile row range [start_row, end_row)
    end_row: int
    start_col: int
    end_col: int
    layer_id: int          # u16 owning layer (ready-list key)
    deps: tuple[int, ...] = ()   # variable tail: u16 count + u16 ids

    FIELDS = (
        _F("ddr_addr", 4), _F("src_lmu", 1), _F("des_lmu", 1),
        _F("M", 4), _F("N", 4),
        _F("start_row", 4), _F("end_row", 4),
        _F("start_col", 4), _F("end_col", 4),
        _F("layer_id", 2),
    )
    OP_TYPES = (OpType.MIU_LOAD, OpType.MIU_STORE)

    def _pack_tail(self) -> bytes:
        out = struct.pack("<H", len(self.deps))
        for d in self.deps:
            out += struct.pack("<H", d)
        return out

    @classmethod
    def _unpack_tail(cls, raw: bytes, off: int) -> dict:
        (n,) = struct.unpack_from("<H", raw, off)
        off += 2
        deps = struct.unpack_from(f"<{n}H", raw, off) if n else ()
        off += 2 * n
        if off != len(raw):
            raise ValueError("MIUBody trailing bytes")
        return {"deps": tuple(deps)}


@dataclass
class SFUBody(Body):
    """Row-streaming non-linear op over ``count`` rows of ``ele_num``
    elements, LMU->SFU->LMU (paper §3.5)."""

    src_lmu: int   # u8
    des_lmu: int   # u8
    count: int     # u16 rows
    ele_num: int   # u32 elements per row

    FIELDS = (_F("src_lmu", 1), _F("des_lmu", 1),
              _F("count", 2), _F("ele_num", 4))
    OP_TYPES = (OpType.SFU_SOFTMAX, OpType.SFU_GELU, OpType.SFU_LAYERNORM,
                OpType.SFU_RELU, OpType.SFU_RELU2, OpType.SFU_SILU)


@dataclass
class LMUBody(Body):
    """LMU configuration / tile forwarding (paper §3.2).

    LMU_CFG: assign ``role`` and logical-buffer ``group`` (LMUs with the
    same group compose into one larger logical buffer).
    LMU_MOVE: stream the [rows x cols] region ``count`` times to
    ``des_pu`` (a PU is any functional unit port on the network).
    """

    ping_buf: int   # u8
    pong_buf: int   # u8
    load_op: int    # u8 (bool) accept incoming stream
    send_op: int    # u8 (bool) drive outgoing stream
    src_pu: int     # u8
    des_pu: int     # u8
    count: int      # u16
    start_row: int  # u32
    end_row: int
    start_col: int
    end_col: int
    role: int = 0   # u8 LmuRole (CFG)
    group: int = 0  # u8 logical-buffer id (CFG)

    FIELDS = (_F("ping_buf", 1), _F("pong_buf", 1),
              _F("load_op", 1), _F("send_op", 1),
              _F("src_pu", 1), _F("des_pu", 1), _F("count", 2),
              _F("start_row", 4), _F("end_row", 4),
              _F("start_col", 4), _F("end_col", 4),
              _F("role", 1), _F("group", 1))
    OP_TYPES = (OpType.LMU_CFG, OpType.LMU_MOVE)


@dataclass
class MMUBody(Body):
    """Tiled GEMM with *dynamic loop bounds* (paper §3.3, Fig. 4b).

    ``bound_i/k/j`` are the runtime loop bounds consumed by the resident
    kernel program — the flexible-parallelism mechanism. ``accumulate``
    accumulates into the OUT logical buffer (for K-tiling), ``epilogue``
    fuses the trailing non-linearity.
    """

    ping_op: int    # u8
    pong_op: int    # u8
    bound_i: int    # u32
    bound_k: int    # u32
    bound_j: int    # u32
    src_lmu: int    # u8 LHS logical buffer
    src_lmu_rhs: int  # u8 RHS logical buffer
    des_lmu: int    # u8 OUT logical buffer
    accumulate: int = 0  # u8 bool
    epilogue: int = 0    # u8 Epilogue
    count: int = 1       # u16 repeat count

    FIELDS = (_F("ping_op", 1), _F("pong_op", 1),
              _F("bound_i", 4), _F("bound_k", 4), _F("bound_j", 4),
              _F("src_lmu", 1), _F("src_lmu_rhs", 1), _F("des_lmu", 1),
              _F("accumulate", 1), _F("epilogue", 1), _F("count", 2))
    OP_TYPES = (OpType.MMU_GEMM,)


_BODY_FOR_OP: dict[OpType, type[Body]] = {}
for _cls in (MIUBody, SFUBody, LMUBody, MMUBody):
    for _op in _cls.OP_TYPES:
        _BODY_FOR_OP[_op] = _cls


@dataclass
class Instruction:
    is_last: bool
    unit_kind: UnitKind
    unit_index: int       # u8
    op_type: OpType
    body: Body | None     # None only for IDU_HALT

    def encode(self) -> bytes:
        body = self.body.pack() if self.body is not None else b""
        if len(body) >= (1 << 12):
            raise ValueError(f"body too long: {len(body)}")
        if not 0 <= self.unit_index < (1 << 8):
            raise ValueError(f"unit_index out of range: {self.unit_index}")
        hdr = ((int(self.is_last) & 0x1) << 31
               | (int(self.unit_kind) & 0x7) << 28
               | (self.unit_index & 0xFF) << 20
               | (int(self.op_type) & 0xFF) << 12
               | (len(body) & 0xFFF))
        return struct.pack("<I", hdr) + body

    @classmethod
    def decode_from(cls, raw: bytes, off: int) -> tuple["Instruction", int]:
        (hdr,) = struct.unpack_from("<I", raw, off)
        off += 4
        is_last = bool((hdr >> 31) & 0x1)
        kind = UnitKind((hdr >> 28) & 0x7)
        index = (hdr >> 20) & 0xFF
        op = OpType((hdr >> 12) & 0xFF)
        blen = hdr & 0xFFF
        body_raw = raw[off:off + blen]
        off += blen
        body = _BODY_FOR_OP[op].unpack(body_raw) if op in _BODY_FOR_OP else None
        return cls(is_last, kind, index, op, body), off


@dataclass
class Program:
    """A DORA binary: the flat instruction sequence the IDU consumes,
    plus the decoded per-unit streams it dispatches (paper §3.6)."""

    instructions: list[Instruction] = field(default_factory=list)

    def append(self, instr: Instruction) -> None:
        self.instructions.append(instr)

    # --- binary round trip -------------------------------------------------
    def encode(self) -> bytes:
        return b"".join(i.encode() for i in self.instructions)

    @classmethod
    def decode(cls, raw: bytes) -> "Program":
        out, off = cls(), 0
        while off < len(raw):
            instr, off = Instruction.decode_from(raw, off)
            out.append(instr)
        return out

    # --- IDU dispatch ------------------------------------------------------
    def dispatch(self) -> dict[tuple[UnitKind, int], list[Instruction]]:
        """IDU behaviour: fetch headers, route bodies by des_unit, stop a
        unit's stream at is_last."""
        streams: dict[tuple[UnitKind, int], list[Instruction]] = {}
        halted: set[tuple[UnitKind, int]] = set()
        for instr in self.instructions:
            key = (instr.unit_kind, instr.unit_index)
            if key in halted:
                raise ValueError(f"instruction for halted unit {key}")
            streams.setdefault(key, []).append(instr)
            if instr.is_last:
                halted.add(key)
        return streams

    def units(self) -> Iterator[tuple[UnitKind, int]]:
        seen = set()
        for i in self.instructions:
            key = (i.unit_kind, i.unit_index)
            if key not in seen:
                seen.add(key)
                yield key

    def __len__(self) -> int:
        return len(self.instructions)

    def byte_size(self) -> int:
        return len(self.encode())


def mk(unit_kind: UnitKind, unit_index: int, op: OpType, body: Body | None,
       is_last: bool = False) -> Instruction:
    """Convenience constructor with op/body consistency checking."""
    expected = _BODY_FOR_OP.get(op)
    if expected is not None and not isinstance(body, expected):
        raise TypeError(f"{op.name} needs {expected.__name__}, "
                        f"got {type(body).__name__}")
    return Instruction(is_last, unit_kind, unit_index, op, body)


def disassemble(program: Program) -> str:
    lines = []
    for i in program.instructions:
        tail = " [LAST]" if i.is_last else ""
        body = "" if i.body is None else " " + ", ".join(
            f"{f.name}={getattr(i.body, f.name)}" for f in i.body.FIELDS)
        if isinstance(i.body, MIUBody) and i.body.deps:
            body += f", deps={list(i.body.deps)}"
        lines.append(f"{i.unit_kind.name}{i.unit_index}: "
                     f"{i.op_type.name}{body}{tail}")
    return "\n".join(lines)
