// Counterpart of transformer-visualize/src/components/AttentionMatrix.vue:
// an S×S attention-weight grid, cells colored by weight, hover popover
// with query/key token and attention %. DOM grid (faithful to the
// reference) up to 64 tokens; canvas heatmap beyond that so long
// sequences stay responsive.
import { card, tohex } from "./util.js";

const DOM_LIMIT = 64;

function tokenString(tokens, i) {
  return tokens?.[i]?.token ?? `[Token ${i + 1}]`;
}

export function AttentionMatrix({ size, color, values, tokens, layer_id }) {
  const box = card(`Layer ${layer_id} Attention Matrix`);
  const valid = values && values.length === size &&
    values.every(r => r && r.length === size);
  if (!valid) {
    const empty = document.createElement("div");
    empty.style.cssText = "color:#778;font-size:12px;";
    empty.textContent =
      `Layer ${layer_id} attention data not available or mismatched ` +
      "dimensions.";
    box.appendChild(empty);
    return box;
  }
  if (size > DOM_LIMIT) {
    const canvas = document.createElement("canvas");
    canvas.width = size; canvas.height = size;
    canvas.style.cssText =
      "width:100%;image-rendering:pixelated;border-radius:4px;";
    const ctx = canvas.getContext("2d");
    const img = ctx.createImageData(size, size);
    for (let i = 0; i < size; i++)
      for (let j = 0; j < size; j++) {
        const v = Math.max(0, Math.min(1, values[i][j]));
        const o = (i * size + j) * 4;
        img.data[o] = 255 * (color[0] * v + (1 - v));
        img.data[o + 1] = 255 * (color[1] * v + (1 - v));
        img.data[o + 2] = 255 * (color[2] * v + (1 - v));
        img.data[o + 3] = 255;
      }
    ctx.putImageData(img, 0, 0);
    canvas.title = `attention ${size}×${size} (hover grid shown below ` +
      `${DOM_LIMIT} tokens)`;
    box.appendChild(canvas);
    return box;
  }
  const grid = document.createElement("div");
  grid.style.cssText =
    `display:grid;grid-template-columns:repeat(${size},1fr);` +
    "border:1px solid #333;aspect-ratio:1;";
  for (let i = 0; i < size; i++) {
    for (let j = 0; j < size; j++) {
      const cellWrap = document.createElement("div");
      cellWrap.style.cssText =
        "aspect-ratio:1;display:flex;align-items:center;" +
        "justify-content:center;";
      const cell = document.createElement("div");
      cell.style.cssText =
        "width:90%;height:90%;border-radius:2px;" +
        `background-color:${tohex(color, values[i][j])};`;
      cell.title =
        `Query: ${tokenString(tokens, i)} (idx ${i})\n` +
        `Key: ${tokenString(tokens, j)} (idx ${j})\n` +
        `Attention: ${(values[i][j] * 100).toFixed(2)}%`;
      cellWrap.appendChild(cell);
      grid.appendChild(cellWrap);
    }
  }
  box.appendChild(grid);
  return box;
}
