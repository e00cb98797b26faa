// Counterpart of transformer-visualize/src/components/MLPVectors.vue:
// a flex row of per-token MLPVector strips. The reference hardcodes its
// model's 64-dim hidden; here the dimension comes from the payload.
import { MLPVector } from "./MLPVector.js";

export function MLPVectors({ color, values, dim }) {
  const el = document.createElement("div");
  el.style.cssText = "display:flex;flex-wrap:wrap;gap:4px;";
  if (!values || !values.length || !dim) return el;
  const nTokens = Math.floor(values.length / dim);
  for (let i = 0; i < nTokens; i++) {
    el.appendChild(MLPVector({
      length: dim,
      color,
      values: values.slice(i * dim, (i + 1) * dim),
    }));
  }
  return el;
}
