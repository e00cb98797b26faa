// Counterpart of transformer-visualize/src/components/PCAPlot.vue: a
// 2-D scatter of PCA-projected activations, one color per batch with a
// legend and hover tooltip showing the point's token — canvas instead
// of chart.js (no external deps), same dataset semantics.
import { card } from "./util.js";

const BATCH_COLORS = [
  "rgba(75,192,192,", "rgba(255,99,132,", "rgba(54,162,235,",
  "rgba(255,206,86,", "rgba(153,102,255,", "rgba(255,159,64,",
  "rgba(100,100,100,", "rgba(200,100,50,",
];

export function batchColor(i, alpha = 1) {
  return BATCH_COLORS[i % BATCH_COLORS.length] + alpha + ")";
}

export function PCAPlot({ values, layerId, tokens }) {
  const box = card(`Layer ${layerId} PCA`);
  const canvas = document.createElement("canvas");
  canvas.width = 340; canvas.height = 200;
  canvas.style.cssText = "width:100%;background:#15151d;border-radius:4px;";
  box.appendChild(canvas);
  const ctx = canvas.getContext("2d");
  if (!values || !values.length) return box;

  const pts = [];   // {x, y, batch, token}
  values.forEach((batchData, b) => (batchData || []).forEach((p, i) =>
    pts.push({ x: p[0], y: p[1], batch: b,
               token: tokens?.[b]?.[i]?.token ?? `[Token ${i + 1}]` })));
  if (!pts.length) return box;
  const xs = pts.map(p => p.x), ys = pts.map(p => p.y);
  const xlo = Math.min(...xs), xhi = Math.max(...xs);
  const ylo = Math.min(...ys), yhi = Math.max(...ys);
  const px = p => 10 + (p.x - xlo) / (xhi - xlo + 1e-9) *
    (canvas.width - 20);
  const py = p => canvas.height - 10 -
    (p.y - ylo) / (yhi - ylo + 1e-9) * (canvas.height - 20);

  function draw(hover) {
    ctx.clearRect(0, 0, canvas.width, canvas.height);
    for (const p of pts) {
      ctx.fillStyle = batchColor(p.batch, p === hover ? 1 : 0.7);
      ctx.beginPath();
      ctx.arc(px(p), py(p), p === hover ? 6 : 4, 0, 7);
      ctx.fill();
    }
    // Legend: one entry per batch.
    const nb = values.length;
    for (let b = 0; b < nb; b++) {
      ctx.fillStyle = batchColor(b);
      ctx.fillRect(8, 8 + 14 * b, 10, 10);
      ctx.fillStyle = "#aab";
      ctx.font = "10px monospace";
      ctx.fillText(`Batch ${b + 1}`, 22, 17 + 14 * b);
    }
    if (hover) {
      ctx.fillStyle = "#fff";
      ctx.font = "11px monospace";
      ctx.fillText(
        `${hover.token} (${hover.x.toFixed(3)}, ${hover.y.toFixed(3)})`,
        Math.min(px(hover) + 8, canvas.width - 130), py(hover) - 8);
    }
  }
  canvas.onmousemove = ev => {
    const r = canvas.getBoundingClientRect();
    const mx = (ev.clientX - r.left) * canvas.width / r.width;
    const my = (ev.clientY - r.top) * canvas.height / r.height;
    let best = null, bd = 100;
    for (const p of pts) {
      const d = (px(p) - mx) ** 2 + (py(p) - my) ** 2;
      if (d < bd) { bd = d; best = p; }
    }
    draw(best);
  };
  canvas.onmouseleave = () => draw(null);
  draw(null);
  return box;
}
