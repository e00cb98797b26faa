// Counterpart of transformer-visualize/src/components/ColoredVector.vue:
// one token's vector as a horizontal strip of per-dimension color
// segments, min/max-normalized, hover tooltip with the raw value.
import { tohex } from "./util.js";

export function ColoredVector({ length, colors, values }) {
  const el = document.createElement("div");
  el.className = "colored-vector";
  el.style.cssText = "display:flex;height:25px;width:100%;";
  if (!values || !values.length) return el;
  const min = Math.min(...values), max = Math.max(...values);
  const range = max - min, flat = range < 1e-6;
  for (let i = 0; i < length; i++) {
    const seg = document.createElement("div");
    const v = values[i];
    const norm = flat ? 0.5 : (v - min) / range;
    const color = (i < values.length && colors && colors[i])
      ? tohex(colors[i], norm) : "#CCCCCC";
    seg.style.cssText =
      `flex-grow:1;background-color:${color};min-width:1px;`;
    seg.title = `Value: ${v?.toFixed(4)}`;
    el.appendChild(seg);
  }
  return el;
}
