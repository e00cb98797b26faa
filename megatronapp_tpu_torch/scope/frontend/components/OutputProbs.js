// Counterpart of transformer-visualize/src/components/OutputProbs.vue:
// the sampled token highlighted, then the top-k candidates sorted by
// probability as rounded tags (with probability bars — the inference
// server supplies up to top-20 candidates per step).
export function OutputProbs({ data }) {
  const el = document.createElement("div");
  el.className = "output-probs";
  const valid = data && data.probs && data.probs.length && data.sampled;
  if (!valid) {
    el.style.cssText = "color:#778;font-size:12px;";
    el.textContent = "waiting for output probabilities…";
    return el;
  }
  const head = document.createElement("div");
  head.style.cssText = "margin-bottom:6px;font-size:13px;";
  const headTag = document.createElement("span");
  headTag.style.cssText =
    "background:#2fb36f;color:#fff;border-radius:10px;padding:2px 10px;";
  headTag.textContent =
    `${JSON.stringify(data.sampled.token)}: ` +
    `${(data.sampled.probability * 100).toFixed(2)}% 🎯`;
  head.append("Sampled token: ", headTag);
  el.appendChild(head);

  const list = document.createElement("div");
  list.style.cssText = "display:flex;flex-wrap:wrap;gap:4px;";
  const sorted = [...data.probs].sort(
    (a, b) => b.probability - a.probability);
  for (const item of sorted) {
    const tag = document.createElement("span");
    const sampled = item.id === data.sampled.id;
    tag.style.cssText =
      "border-radius:10px;padding:2px 10px;font-size:12px;" +
      (sampled ? "background:#2fb36f;color:#fff;"
               : "background:#23232e;color:#bbc;");
    tag.textContent =
      `${JSON.stringify(item.token)}: ` +
      `${(item.probability * 100).toFixed(2)}%` + (sampled ? " 🎯" : "");
    list.appendChild(tag);
  }
  el.appendChild(list);
  return el;
}
