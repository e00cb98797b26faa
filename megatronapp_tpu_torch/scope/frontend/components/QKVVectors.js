// Counterpart of transformer-visualize/src/components/QKVVectors.vue:
// a flex row of per-token QKVVector strips. The reference hardcodes its
// model's 96-dim projection; here the dimension comes from the payload.
import { QKVVector } from "./QKVVector.js";

export function QKVVectors({ colors, values, dim }) {
  const el = document.createElement("div");
  el.style.cssText = "display:flex;flex-wrap:wrap;gap:4px;";
  if (!values || !values.length || !dim) return el;
  const nTokens = Math.floor(values.length / dim);
  for (let i = 0; i < nTokens; i++) {
    el.appendChild(QKVVector({
      length: dim,
      colors,
      values: values.slice(i * dim, (i + 1) * dim),
    }));
  }
  return el;
}
