// Counterpart of transformer-visualize/src/components/QKVVector.vue:
// one token's Q/K/V projection as an SVG strip, each dimension a 2px
// rect colored by its per-dimension hue scaled by the normalized value.
import { tohex } from "./util.js";

const SVG = "http://www.w3.org/2000/svg";

export function QKVVector({ length, colors, values }) {
  const svg = document.createElementNS(SVG, "svg");
  const w = 2 * length, h = 10;
  svg.setAttribute("width", w);
  svg.setAttribute("height", h);
  svg.setAttribute("viewBox", `0 0 ${w} ${h}`);
  if (!values || !values.length) return svg;
  const min = Math.min(...values), max = Math.max(...values);
  for (let i = 0; i < length; i++) {
    const rect = document.createElementNS(SVG, "rect");
    rect.setAttribute("x", 2 * i);
    rect.setAttribute("y", 0);
    rect.setAttribute("width", 2);
    rect.setAttribute("height", h);
    const norm = (values[i] - min) / (max - min + 1e-9);
    rect.setAttribute("fill", tohex(colors[i] || [0.5, 0.5, 0.5], norm));
    const t = document.createElementNS(SVG, "title");
    t.textContent = `dim ${i}: ${values[i]?.toFixed(4)}`;
    rect.appendChild(t);
    svg.appendChild(rect);
  }
  return svg;
}
