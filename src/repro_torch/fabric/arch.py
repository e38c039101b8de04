"""Fabric architecture spec: N x M PE tile grid, mesh interconnect, IO ring.

The array model follows the paper's Fig. 7 layout and the Garnet-class CGRAs
it targets: an ``rows x cols`` grid of PE tiles connected by a bidirectional
mesh (``channel_width`` tracks per direction per channel), surrounded by a
perimeter ring of I/O tiles (one per non-corner boundary position) that
stream application inputs/outputs and host the memory interfaces.

Coordinates are ``(x, y)`` with PE tiles at ``0 <= x < cols`` and
``0 <= y < rows``.  I/O sites sit just outside the grid: ``(x, -1)`` (north),
``(x, rows)`` (south), ``(-1, y)`` (west) and ``(cols, y)`` (east).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Tuple

Coord = Tuple[int, int]
Edge = Tuple[Coord, Coord]     # directed (src tile, dst tile)


@dataclass(frozen=True)
class FabricSpec:
    rows: int = 8
    cols: int = 8
    channel_width: int = 4       # tracks per direction per mesh channel
    io_capacity: int = 4         # distinct signals one I/O tile can stream
    hop_energy_pj: float = 0.035  # per word per switch-to-switch hop (16 nm)
    hop_delay_ns: float = 0.055   # wire + switch delay per hop
    latch_depth: int = 4         # per-input iteration FIFO depth: an operand
    # word survives latch_depth initiation intervals before the stream
    # overwrites it, so consumer fire times may lag producer arrivals by up
    # to latch_depth x II (Garnet-style input FIFOs; bounds operand skew)

    def __post_init__(self) -> None:
        if self.rows < 2 or self.cols < 2:
            raise ValueError("fabric must be at least 2x2")
        if self.channel_width < 1 or self.io_capacity < 1:
            raise ValueError("channel_width and io_capacity must be >= 1")
        if self.latch_depth < 1:
            raise ValueError("latch_depth must be >= 1")

    # -- tiles -------------------------------------------------------------
    @property
    def n_pe_tiles(self) -> int:
        return self.rows * self.cols

    @property
    def n_io_sites(self) -> int:
        return 2 * self.rows + 2 * self.cols

    def pe_tiles(self) -> List[Coord]:
        return [(x, y) for y in range(self.rows) for x in range(self.cols)]

    def io_sites(self) -> List[Coord]:
        north = [(x, -1) for x in range(self.cols)]
        south = [(x, self.rows) for x in range(self.cols)]
        west = [(-1, y) for y in range(self.rows)]
        east = [(self.cols, y) for y in range(self.rows)]
        return north + south + west + east

    def is_pe(self, t: Coord) -> bool:
        return 0 <= t[0] < self.cols and 0 <= t[1] < self.rows

    def is_io(self, t: Coord) -> bool:
        x, y = t
        if y in (-1, self.rows):
            return 0 <= x < self.cols
        if x in (-1, self.cols):
            return 0 <= y < self.rows
        return False

    # -- routing graph -----------------------------------------------------
    def neighbors(self, t: Coord) -> List[Coord]:
        """Adjacent routable tiles (mesh for PEs; single port for IO)."""
        x, y = t
        if self.is_io(t):
            inward = (min(max(x, 0), self.cols - 1),
                      min(max(y, 0), self.rows - 1))
            return [inward]
        out = []
        for dx, dy in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            n = (x + dx, y + dy)
            if self.is_pe(n) or self.is_io(n):
                out.append(n)
        return out

    def edge_capacity(self, a: Coord, b: Coord) -> int:
        """Track count of directed channel a -> b."""
        if self.is_io(a) or self.is_io(b):
            return self.io_capacity
        return self.channel_width

    def routing_edges(self) -> Dict[Edge, int]:
        """All directed channels with capacities."""
        caps: Dict[Edge, int] = {}
        for t in self.pe_tiles() + self.io_sites():
            for n in self.neighbors(t):
                caps[(t, n)] = self.edge_capacity(t, n)
                caps[(n, t)] = self.edge_capacity(n, t)
        return caps

    # -- sizing ------------------------------------------------------------
    def fit(self, n_pe_cells: int, n_io_cells: int = 0) -> "FabricSpec":
        """Smallest square-ish spec (same channel/IO params) that fits the
        given cell counts; returns self when already large enough."""
        rows, cols = self.rows, self.cols
        while rows * cols < n_pe_cells or 2 * (rows + cols) < n_io_cells:
            if cols <= rows:
                cols += 1
            else:
                rows += 1
        if (rows, cols) == (self.rows, self.cols):
            return self
        return FabricSpec(rows=rows, cols=cols,
                          channel_width=self.channel_width,
                          io_capacity=self.io_capacity,
                          hop_energy_pj=self.hop_energy_pj,
                          hop_delay_ns=self.hop_delay_ns,
                          latch_depth=self.latch_depth)

    def summary(self) -> str:
        return (f"Fabric[{self.cols}x{self.rows} PEs | "
                f"{self.n_io_sites} IO | W={self.channel_width}]")


def manhattan(a: Coord, b: Coord) -> int:
    return abs(a[0] - b[0]) + abs(a[1] - b[1])
