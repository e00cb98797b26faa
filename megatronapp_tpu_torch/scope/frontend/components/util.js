// Shared helpers for the component tree (the reference repeats tohex in
// every component; here it is one module).

// [r,g,b] in 0..1 + intensity in 0..1 → '#rrggbb' (white → full color),
// the reference's tohex.
export function tohex(baseColor, value) {
  const v = Math.max(0, Math.min(1, value));
  return "#" + baseColor
    .map(c => Math.round(255 * (c * v + (1 - v)))
      .toString(16).padStart(2, "0"))
    .join("");
}

// Default per-dimension rainbow used by the reference AppContent for
// QKV vectors: stable hue per dimension index.
export function dimColors(n) {
  return Array.from({ length: n }, (_, i) => {
    const h = (i / Math.max(1, n)) * 300;
    return hsl2rgb(h, 0.75, 0.5);
  });
}

export function hsl2rgb(h, s, l) {
  const a = s * Math.min(l, 1 - l);
  const f = k => {
    const x = (k + h / 30) % 12;
    return l - a * Math.max(-1, Math.min(x - 3, 9 - x, 1));
  };
  return [f(0), f(8), f(4)];
}

// Flatten an arbitrarily-nested numeric array to 2-D rows (batched
// payloads stack vertically) — shared by matrix-shaped components.
export function flat2d(x) {
  if (!Array.isArray(x)) return [[x]];
  if (!Array.isArray(x[0])) return [x];
  const rows = [];
  const rec = a => {
    if (!Array.isArray(a[0])) { rows.push(a); return; }
    a.forEach(rec);
  };
  rec(x);
  return rows;
}

export function card(title) {
  const box = document.createElement("div");
  box.className = "ncard";
  const h = document.createElement("h3");
  h.textContent = title;
  h.style.cssText = "font-size:12px;margin:0 0 6px;color:#aac;";
  box.appendChild(h);
  return box;
}
