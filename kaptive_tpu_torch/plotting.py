r"""Interactive locus diagrams and multi-locus synteny maps as self-contained HTML/SVG.

Capability parity with ``kaptive/plotting.py``:
``BasePlotter`` (:33-144), ``GeneStyleManager`` (:147-184), vectorised gene
glyph geometry (``GeneGlyphPlotter`` :187-413), ``LocusBackbonePlotter``
(:416-447), ``SerotypingResultPlotter`` (:450-642, piece layout via
``Intervals.arrange``), and ``LocusComparisonPlotter`` with homology ribbons
(:645-962, union-find clusters :652-690, median-shift offset alignment
:692-744).

Design difference: the reference emits Plotly figures that load plotly.js from
a CDN.  Here figures are dependency-free SVG embedded in a single HTML file
with the same interaction model — wheel zoom + drag pan (SVG viewBox), click
-to-toggle legend entries, floating hover tooltips (plus ``<title>`` fallback
when scripts are disabled) — implemented by a ~50-line inline controller, so
the file stays fully offline with no JS dependency, while keeping the
reference's visual semantics (gene arrows coloured by state, backbone lines
per piece, homology ribbons shaded by protein identity).
"""

from __future__ import annotations

import html
from dataclasses import dataclass, field
from pathlib import Path
from typing import TYPE_CHECKING

import numpy as np

from kaptive_tpu_torch.core.interval import Intervals
from kaptive_tpu_torch.serotyping.models import GeneState, SerotypingResult

if TYPE_CHECKING:
    from kaptive_tpu_torch.compare import LocusComparisons, LocusData


# Figure ----------------------------------------------------------------------------------------------------------------
@dataclass
class Figure:
    r"""Minimal SVG figure: collected elements + HTML writer."""

    width: int = 1200
    height: int = 300
    title: str = ""
    elements: list[str] = field(default_factory=list)

    def add(self, svg: str) -> None:
        self.elements.append(svg)

    def to_svg(self) -> str:
        return (
            f'<svg xmlns="http://www.w3.org/2000/svg" viewBox="0 0 {self.width} {self.height}" '
            f'width="{self.width}" height="{self.height}" font-family="sans-serif">'
            + "".join(self.elements)
            + "</svg>"
        )

    # Inline interaction controller: wheel zoom around the cursor + drag pan
    # via the SVG viewBox, double-click reset, legend click-to-toggle (by the
    # entry's data-target class), and a floating tooltip fed by data-tip
    # attributes.  <title> children remain as the scriptless fallback.
    _SCRIPT = """
(function(){
  var svg=document.querySelector('svg');if(!svg)return;
  var vb=svg.viewBox.baseVal;var init=[vb.x,vb.y,vb.width,vb.height];
  function pt(e){var r=svg.getBoundingClientRect();
    return [vb.x+(e.clientX-r.left)/r.width*vb.width,
            vb.y+(e.clientY-r.top)/r.height*vb.height];}
  svg.addEventListener('wheel',function(e){e.preventDefault();
    var f=e.deltaY<0?0.8:1.25;var p=pt(e);
    vb.x=p[0]-(p[0]-vb.x)*f;vb.y=p[1]-(p[1]-vb.y)*f;
    vb.width*=f;vb.height*=f;},{passive:false});
  var drag=null;
  svg.addEventListener('mousedown',function(e){drag=pt(e);});
  window.addEventListener('mouseup',function(){drag=null;});
  svg.addEventListener('mousemove',function(e){if(!drag)return;
    var p=pt(e);vb.x+=drag[0]-p[0];vb.y+=drag[1]-p[1];});
  svg.addEventListener('dblclick',function(){
    vb.x=init[0];vb.y=init[1];vb.width=init[2];vb.height=init[3];});
  document.querySelectorAll('.legend-item').forEach(function(el){
    el.addEventListener('click',function(){
      var off=el.classList.toggle('legend-off');
      document.querySelectorAll('.'+el.getAttribute('data-target')).forEach(
        function(g){g.style.display=off?'none':'';});});});
  var tip=document.createElement('div');tip.id='tip';document.body.appendChild(tip);
  document.querySelectorAll('svg [data-tip] title').forEach(function(t){t.remove();});
  document.querySelectorAll('[data-tip]').forEach(function(el){
    el.addEventListener('mousemove',function(e){
      tip.textContent=el.getAttribute('data-tip');tip.style.display='block';
      tip.style.left=(e.pageX+12)+'px';tip.style.top=(e.pageY+12)+'px';});
    el.addEventListener('mouseleave',function(){tip.style.display='none';});});
})();
"""

    def to_html(self) -> str:
        return (
            "<!DOCTYPE html><html><head><meta charset='utf-8'>"
            f"<title>{html.escape(self.title)}</title>"
            "<style>body{margin:1em;font-family:sans-serif}svg{max-width:100%;height:auto}"
            "polygon:hover,rect:hover,path:hover{opacity:0.7}"
            ".legend-item{cursor:pointer}.legend-off{opacity:0.35}"
            "#tip{position:absolute;display:none;background:#222;color:#fff;"
            "padding:4px 8px;border-radius:4px;font-size:12px;pointer-events:none}"
            "</style></head><body>"
            f"<h3>{html.escape(self.title)}</h3>"
            "<p style='color:#888;font-size:11px'>scroll to zoom, drag to pan, "
            "double-click to reset, click legend entries to toggle</p>"
            f"{self.to_svg()}<script>{self._SCRIPT}</script></body></html>"
        )

    def write_html(self, path: str | Path, **_: object) -> None:
        Path(path).write_text(self.to_html())


class GeneStyleManager:
    r"""Maps gene states / descriptions to fill colours (ref :147-184)."""

    STATE_COLORS = {
        GeneState.NORMAL.value: "#4C72B0",
        GeneState.PARTIAL.value: "#DD8452",
        GeneState.TRUNCATED.value: "#C44E52",
        GeneState.NOVEL.value: "#8172B3",
    }
    STATE_NAMES = {
        GeneState.NORMAL.value: "normal",
        GeneState.PARTIAL.value: "partial",
        GeneState.TRUNCATED.value: "truncated",
        GeneState.NOVEL.value: "novel",
    }
    _PALETTE = [
        "#4C72B0", "#DD8452", "#55A868", "#C44E52", "#8172B3",
        "#937860", "#DA8BC3", "#8C8C8C", "#CCB974", "#64B5CD",
    ]

    def __init__(self) -> None:
        self._desc_colors: dict[str, str] = {}

    def color_for_state(self, state: int) -> str:
        return self.STATE_COLORS.get(int(state), "#999999")

    def color_for_description(self, desc: str) -> str:
        if desc not in self._desc_colors:
            self._desc_colors[desc] = self._PALETTE[len(self._desc_colors) % len(self._PALETTE)]
        return self._desc_colors[desc]


def gene_arrow_points(
    x0: float, x1: float, y: float, h: float, strand: int, head: float = 8.0
) -> str:
    r"""Vertex string for a gene arrow polygon (ref glyph geometry :187-413)."""
    head = min(head, abs(x1 - x0))
    ym, yt, yb = y, y - h / 2, y + h / 2
    if strand >= 0:
        pts = [(x0, yt), (x1 - head, yt), (x1, ym), (x1 - head, yb), (x0, yb)]
    else:
        pts = [(x1, yt), (x0 + head, yt), (x0, ym), (x0 + head, yb), (x1, yb)]
    return " ".join(f"{px:.1f},{py:.1f}" for px, py in pts)


class BasePlotter:
    r"""Shared scaling and backbone drawing for locus figures (ref :33-144)."""

    margin = 40
    row_height = 70
    gene_height = 22

    def _scale(self, total_bp: int, width: int) -> float:
        usable = width - 2 * self.margin
        return usable / max(total_bp, 1)

    def _backbone(self, fig: Figure, x0: float, x1: float, y: float) -> None:
        fig.add(
            f'<line x1="{x0:.1f}" y1="{y:.1f}" x2="{x1:.1f}" y2="{y:.1f}" '
            'stroke="#333" stroke-width="2"/>'
        )


class SerotypingResultPlotter(BasePlotter):
    r"""Locus diagram for one serotyping result (ref :450-642).

    Gene hits inside the locus are drawn as arrows along the arranged piece
    backbone, coloured by gene state, with hover tooltips carrying gene id,
    identity, coverage and state.
    """

    def __call__(self, result: SerotypingResult) -> Figure:
        fig = Figure(
            title=f"{result.genome} — {result.best_locus_name} "
            f"({result.phenotype}, {'Typeable' if result.typeable else 'Untypeable'})"
        )
        style = GeneStyleManager()
        hits = result.gene_hits
        pieces = result.locus_pieces
        n_pieces = len(pieces)
        if n_pieces == 0 or len(hits) == 0:
            fig.add(
                f'<text x="{self.margin}" y="50" fill="#666">No locus pieces found</text>'
            )
            fig.height = 100
            return fig

        # Arrange hit intervals across pieces into one 1-D plot space (ref :527-535).
        inside = hits.is_inside
        piece_of_hit = np.full(len(hits), -1, dtype=np.int64)
        for pi in range(n_pieces):
            on_piece = (
                (hits.t_indices == pieces.ctg_indices[pi])
                & (hits.t_starts <= pieces.ends[pi])
                & (hits.t_ends >= pieces.starts[pi])
            )
            piece_of_hit[on_piece & (piece_of_hit < 0)] = pi

        arranged = Intervals(hits.t_starts, hits.t_ends, hits.strands).arrange(
            piece_of_hit,
            np.arange(n_pieces),
            pieces.starts,
            pieces.ends,
            pieces.strands,
            gap=500,
        )
        piece_lengths = (pieces.ends - pieces.starts).astype(np.int64)
        total_bp = int(piece_lengths.sum()) + 500 * max(n_pieces - 1, 0)
        sx = self._scale(total_bp, fig.width)
        y = 80
        fig.height = 170

        # Piece backbones.
        x_cursor = 0
        for pi in range(n_pieces):
            x0 = self.margin + x_cursor * sx
            x1 = self.margin + (x_cursor + int(piece_lengths[pi])) * sx
            self._backbone(fig, x0, x1, y)
            fig.add(
                f'<text x="{x0:.1f}" y="{y + 35}" font-size="11" fill="#555">'
                f"piece {pi + 1} (contig {int(pieces.ctg_indices[pi])}: "
                f"{int(pieces.starts[pi])}-{int(pieces.ends[pi])})</text>"
            )
            x_cursor += int(piece_lengths[pi]) + 500

        # Gene arrows.
        for i in range(len(hits)):
            if piece_of_hit[i] < 0 or not inside[i]:
                continue
            x0 = self.margin + arranged.starts[i] * sx
            x1 = self.margin + arranged.ends[i] * sx
            color = style.color_for_state(result.gene_states[i])
            gid = hits.gene_ids[i].decode()
            tip = (
                f"{gid} | {style.STATE_NAMES.get(int(result.gene_states[i]), '?')} | "
                f"identity {result.protein_identities[i]:.2f}% | "
                f"coverage {hits.coverages[i]:.2f}%"
            )
            state_name = GeneStyleManager.STATE_NAMES.get(int(result.gene_states[i]), "other")
            pts = gene_arrow_points(x0, x1, y, self.gene_height, int(arranged.strands[i]))
            fig.add(
                f'<polygon class="gene state-{state_name}" points="{pts}" fill="{color}" '
                f'stroke="#222" stroke-width="0.5" data-tip="{html.escape(tip, quote=True)}">'
                f"<title>{html.escape(tip)}</title></polygon>"
            )

        # Legend: each entry toggles its gene-state class on click.
        lx = self.margin
        for state, name in GeneStyleManager.STATE_NAMES.items():
            fig.add(
                f'<g class="legend-item" data-target="state-{name}">'
                f'<rect x="{lx}" y="{fig.height - 28}" width="12" height="12" '
                f'fill="{GeneStyleManager.STATE_COLORS[state]}"/>'
                f'<text x="{lx + 16}" y="{fig.height - 18}" font-size="11">{name}</text></g>'
            )
            lx += 90
        return fig


class LocusBackbonePlotter(BasePlotter):
    r"""Backbone-with-gene-arrows row for one locus (ref :416-447)."""

    def draw_row(
        self,
        fig: Figure,
        name: str,
        starts: np.ndarray,
        ends: np.ndarray,
        strands: np.ndarray,
        descriptions: np.ndarray,
        colors: list[str],
        y: float,
        sx: float,
        x_offset: float = 0.0,
    ) -> None:
        if len(starts) == 0:
            return
        x0 = self.margin + x_offset + float(starts.min()) * sx
        x1 = self.margin + x_offset + float(ends.max()) * sx
        self._backbone(fig, x0, x1, y)
        fig.add(
            f'<text x="{self.margin}" y="{y - 22}" font-size="12" font-weight="bold">'
            f"{html.escape(name)}</text>"
        )
        for i in range(len(starts)):
            gx0 = self.margin + x_offset + starts[i] * sx
            gx1 = self.margin + x_offset + ends[i] * sx
            pts = gene_arrow_points(gx0, gx1, y, self.gene_height, int(strands[i]))
            tip = html.escape(str(descriptions[i]))
            fig.add(
                f'<polygon class="gene" points="{pts}" fill="{colors[i]}" '
                f'stroke="#222" stroke-width="0.5" data-tip="{html.escape(str(descriptions[i]), quote=True)}">'
                f"<title>{tip}</title></polygon>"
            )


def connected_components(n: int, edges_a: np.ndarray, edges_b: np.ndarray) -> np.ndarray:
    r"""Union-find over homology edges -> component id per gene (ref numba :652-690)."""
    parent = np.arange(n, dtype=np.int64)

    def find(x: int) -> int:
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:  # path compression
            parent[x], x = root, parent[x]
        return root

    for a, b in zip(edges_a, edges_b):
        ra, rb = find(int(a)), find(int(b))
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)
    return np.array([find(i) for i in range(n)], dtype=np.int64)


class LocusComparisonPlotter(BasePlotter):
    r"""Multi-locus synteny map with homology ribbons (ref :645-962).

    Homologous genes across loci are clustered with union-find over the
    comparison edges and share a colour; ribbons connect adjacent rows with
    opacity scaled by protein identity; rows are median-shift aligned.
    """

    def __call__(self, comparisons: "LocusComparisons") -> Figure:
        n = len(comparisons.locus_names)
        fig = Figure(title="Locus comparison", height=self.margin * 2 + 40 + n * self.row_height)
        style = GeneStyleManager()
        iv = comparisons.gene_intervals
        offs = comparisons.locus_offsets
        lens = comparisons.locus_lengths

        def locus_slice(i: int) -> slice:
            return slice(int(offs[i]), int(offs[i]) + int(lens[i]))

        max_bp = int(iv.ends.max()) if len(iv) else 1
        sx = self._scale(max_bp, fig.width)
        row = LocusBackbonePlotter()

        # Homology clusters -> shared colours (ref union-find :652-690).
        total_genes = int(lens.sum())
        comp = connected_components(
            total_genes,
            comparisons.edges.global_query_indices,
            comparisons.edges.global_target_indices,
        )
        comp_color = {}
        colors = []
        for g in range(total_genes):
            c = int(comp[g])
            if c not in comp_color:
                comp_color[c] = style._PALETTE[len(comp_color) % len(style._PALETTE)]
            colors.append(comp_color[c])

        # Median-shift offset alignment between consecutive rows (ref :692-744).
        x_offsets = [0.0] * n
        e = comparisons.edges
        for r in range(1, n):
            mask = (e.query_locus_indices == r - 1) & (e.target_locus_indices == r)
            if mask.any():
                qs = iv.starts[e.global_query_indices[mask]].astype(np.float64)
                ts = iv.starts[e.global_target_indices[mask]].astype(np.float64)
                x_offsets[r] = x_offsets[r - 1] + float(np.median(qs - ts)) * sx

        ys = [self.margin + 40 + r * self.row_height for r in range(n)]

        # Ribbons between adjacent rows, behind the gene glyphs.
        idents = e.alignments.pidents
        for k in range(len(e)):
            i, j = int(e.query_locus_indices[k]), int(e.target_locus_indices[k])
            if j != i + 1:
                continue
            gq, gt = int(e.global_query_indices[k]), int(e.global_target_indices[k])
            q0 = self.margin + x_offsets[i] + iv.starts[gq] * sx
            q1 = self.margin + x_offsets[i] + iv.ends[gq] * sx
            t0 = self.margin + x_offsets[j] + iv.starts[gt] * sx
            t1 = self.margin + x_offsets[j] + iv.ends[gt] * sx
            ident = float(idents[k])
            opacity = 0.15 + 0.5 * max(min(ident / 100.0, 1.0), 0.0)
            rtip = (
                f"{comparisons.gene_names[gq]} ~ {comparisons.gene_names[gt]}: "
                f"{ident:.1f}% identity"
            )
            fig.add(
                f'<path class="ribbon" d="M{q0:.1f},{ys[i] + 12} L{q1:.1f},{ys[i] + 12} '
                f'L{t1:.1f},{ys[j] - 12} L{t0:.1f},{ys[j] - 12} Z" '
                f'fill="#888" opacity="{opacity:.2f}" data-tip="{html.escape(rtip, quote=True)}">'
                f"<title>{html.escape(rtip)}</title></path>"
            )

        for r in range(n):
            sl = locus_slice(r)
            row.draw_row(
                fig,
                comparisons.locus_names[r],
                iv.starts[sl],
                iv.ends[sl],
                iv.strands[sl],
                comparisons.gene_descriptions[sl],
                colors[sl],
                ys[r],
                sx,
                x_offset=x_offsets[r],
            )

        # Legend entry toggling every ribbon at once.
        fig.add(
            '<g class="legend-item" data-target="ribbon">'
            f'<rect x="{self.margin}" y="{fig.height - 24}" width="12" height="12" '
            'fill="#888" opacity="0.5"/>'
            f'<text x="{self.margin + 16}" y="{fig.height - 14}" font-size="11">'
            "homology ribbons (identity-shaded)</text></g>"
        )
        return fig
