// Counterpart of transformer-visualize/src/components/QKVMatrix.vue:
// a rows×cols grid of 10px SVG cells, each colored by its per-cell base
// color scaled by the cell value.
import { tohex } from "./util.js";

const SVG = "http://www.w3.org/2000/svg";

export function QKVMatrix({ rows, cols, colors, values }) {
  const svg = document.createElementNS(SVG, "svg");
  const w = 10 * cols, h = 10 * rows;
  svg.setAttribute("width", w);
  svg.setAttribute("height", h);
  svg.setAttribute("viewBox", `0 0 ${w} ${h}`);
  svg.style.maxWidth = "100%";
  if (!values || !values.length) return svg;
  for (let i = 0; i < rows; i++) {
    for (let j = 0; j < cols; j++) {
      const idx = i * cols + j;
      const rect = document.createElementNS(SVG, "rect");
      rect.setAttribute("x", 10 * j);
      rect.setAttribute("y", 10 * i);
      rect.setAttribute("width", 10);
      rect.setAttribute("height", 10);
      rect.setAttribute(
        "fill", tohex(colors?.[idx] || [0.2, 0.4, 0.9],
                      values[idx] ?? 0));
      const t = document.createElementNS(SVG, "title");
      t.textContent = `[${i},${j}] ${Number(values[idx] ?? 0).toFixed(4)}`;
      rect.appendChild(t);
      svg.appendChild(rect);
    }
  }
  return svg;
}
