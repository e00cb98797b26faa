// Counterpart of transformer-visualize/src/components/HelloWorld.vue
// (the reference keeps its Vite scaffold demo component in the tree) —
// a connectivity smoke card used when no data has arrived yet.
import { card } from "./util.js";

export function HelloWorld({ msg } = {}) {
  const box = card(msg || "MegaScope");
  const p = document.createElement("p");
  p.style.cssText = "font-size:12px;color:#889;";
  p.textContent =
    "Connected component tree is live. Run a training step or a " +
    "generation to populate the panels.";
  box.appendChild(p);
  return box;
}
