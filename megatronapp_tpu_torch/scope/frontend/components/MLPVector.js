// Counterpart of transformer-visualize/src/components/MLPVector.vue:
// one token's MLP activations as an SVG strip with a single base color
// scaled by the min/max-normalized value.
import { tohex } from "./util.js";

const SVG = "http://www.w3.org/2000/svg";

export function MLPVector({ length, color, values }) {
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
    rect.setAttribute("fill", tohex(color, norm));
    const t = document.createElementNS(SVG, "title");
    t.textContent = `dim ${i}: ${values[i]?.toFixed(4)}`;
    rect.appendChild(t);
    svg.appendChild(rect);
  }
  return svg;
}
