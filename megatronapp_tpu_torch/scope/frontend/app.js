// MegaScope application shell — counterpart of the reference SPA's
// src/App.vue + src/AppContent.vue (transformer-visualize): owns the
// two WebSocket contracts (training scope/ws_server.py, inference
// inference/server.py), the visualization/disturbance/compressor
// controls, and composes the component tree in components/ (named 1:1
// after the reference's src/components/*.vue).
import { AttentionMatrix } from "./components/AttentionMatrix.js";
import { ColoredVector } from "./components/ColoredVector.js";
import { HelloWorld } from "./components/HelloWorld.js";
import { MLPVectors } from "./components/MLPVectors.js";
import { OutputProbs } from "./components/OutputProbs.js";
import { PCAPlot } from "./components/PCAPlot.js";
import { QKVMatrix } from "./components/QKVMatrix.js";
import { QKVVectors } from "./components/QKVVectors.js";
import { dimColors, flat2d } from "./components/util.js";

"use strict";
const $ = id => document.getElementById(id);

// ---- tabs ----------------------------------------------------------------
$("tab_train").onclick = () => setTab(true);
$("tab_infer").onclick = () => setTab(false);
function setTab(train) {
  $("train_view").classList.toggle("hidden", !train);
  $("infer_view").classList.toggle("hidden", train);
  $("tab_train").classList.toggle("on", train);
  $("tab_infer").classList.toggle("on", !train);
}

// ---- training mode -------------------------------------------------------
let ws = null, losses = [], gnorms = [], autoTimer = null;
// site -> layer_id -> payload (per-layer retention so the layer selector
// can flip between traced layers, reference per-layer batched stores).
const latest = {};

function connect() {
  ws = new WebSocket(`ws://${location.host}/ws`);
  ws.onopen = () => $("status").textContent = "connected";
  ws.onclose = () => { $("status").textContent = "disconnected";
                       setTimeout(connect, 1500); };
  ws.onmessage = ev => {
    const msg = JSON.parse(ev.data);
    if (msg.type === "step_done") {
      losses.push(msg.loss); gnorms.push(msg.grad_norm);
      $("status").textContent =
        `iter ${msg.iteration}  loss ${msg.loss.toFixed(4)}  ` +
        `gnorm ${msg.grad_norm.toFixed(3)}`;
      refreshLayerChoices();
      drawAll();
      if (autoTimer) requestStep();
    } else if (msg.type === "error") {
      $("status").textContent = "error: " + msg.message;
      stopAuto();
    } else if (msg.type === "pca") {
      latest["pca"] = msg;
    } else if (msg.site) {
      (latest[msg.site] = latest[msg.site] || {})[msg.layer_id] = msg;
    }
  };
}

function tracedLayers() {
  return $("layers").value.split(",")
    .map(s => parseInt(s.trim())).filter(Number.isFinite);
}

function visualizationConfig() {
  const layers = tracedLayers();
  const cfg = {};
  if ($("f_qkv").checked) cfg["QKV_mat_mul"] = layers;
  if ($("f_attn").checked) { cfg["RawAttentionScore"] = layers;
                             cfg["ContextLayer"] = layers; }
  if ($("f_mlp").checked) { cfg["MLP1"] = layers; cfg["MLP2"] = layers; }
  if ($("f_result").checked) cfg["Result"] = [0];
  return cfg;
}

function disturbanceConfig() {
  const cfg = {};
  const rows = [["dw", "weight"], ["dc", "calculation"], ["ds", "system"]];
  for (const [p, site] of rows)
    if ($(p + "_on").checked)
      cfg[site] = { kind: $(p + "_kind").value,
                    scale: parseFloat($(p + "_scale").value) || 0.01,
                    layers: null };
  return cfg;
}

function requestStep() {
  if (!ws || ws.readyState !== 1) return;
  const req = { type: "run_training_step",
                visualization: visualizationConfig(),
                compressor: { pixels: parseInt($("pixels").value) || 16,
                              method: "mean" } };
  const dist = disturbanceConfig();
  if (Object.keys(dist).length) req.disturbance = dist;
  ws.send(JSON.stringify(req));
}

function stopAuto() { if (autoTimer) { autoTimer = null;
                      $("auto").textContent = "auto"; } }
$("step").onclick = requestStep;
$("auto").onclick = () => {
  if (autoTimer) stopAuto();
  else { autoTimer = true; $("auto").textContent = "stop"; requestStep(); }
};
$("sel_layer").onchange = drawAll;
$("sel_head").onchange = drawAll;

function refreshLayerChoices() {
  const ids = new Set();
  for (const site of Object.keys(latest))
    if (site !== "pca")
      Object.keys(latest[site]).forEach(l => ids.add(parseInt(l)));
  const sel = $("sel_layer"), cur = sel.value;
  sel.innerHTML = "";
  [...ids].filter(i => i >= 0).sort((a, b) => a - b).forEach(i => {
    const o = document.createElement("option"); o.value = i;
    o.textContent = i; sel.appendChild(o);
  });
  if ([...sel.options].some(o => o.value === cur)) sel.value = cur;
  const att = sitePayload("attention_probs");
  const heads = att ? countHeads(att.result) : 0;
  const hs = $("sel_head"), hcur = hs.value;
  hs.innerHTML = "";
  const all = document.createElement("option");
  all.value = "all"; all.textContent = "all";
  hs.appendChild(all);
  for (let h = 0; h < heads; h++) {
    const o = document.createElement("option"); o.value = h;
    o.textContent = h; hs.appendChild(o);
  }
  if ([...hs.options].some(o => o.value === hcur)) hs.value = hcur;
}

function sitePayload(site) {
  const per = latest[site];
  if (!per) return null;
  const want = $("sel_layer").value;
  if (want !== "" && per[want]) return per[want];
  const ks = Object.keys(per);
  return ks.length ? per[ks[0]] : null;
}

function countHeads(x) {
  let depth = 0, a = x;
  while (Array.isArray(a)) { depth++; a = a[0]; }
  if (depth < 3) return 0;
  a = x;
  for (let i = 0; i < depth - 3; i++) a = a[0];
  return a.length;
}

function headSlice(x) {
  // Reduce an attention payload to 2-D honoring the head selector:
  // 'all' stacks heads vertically, otherwise one head's [q][k].
  let depth = 0, a = x;
  while (Array.isArray(a)) { depth++; a = a[0]; }
  if (depth < 3) return flat2d(x);
  let arr = x;
  for (let i = 0; i < depth - 3; i++) arr = arr[0];
  const want = $("sel_head").value;
  if (want === "all" || !(want in arr)) return flat2d(arr);
  return flat2d(arr[parseInt(want)]);
}

// ---- composition helpers -------------------------------------------------
function mount(id, node) {
  const host = $(id);
  host.innerHTML = "";
  host.appendChild(node);
}

function normalize01(rows) {
  let lo = Infinity, hi = -Infinity;
  rows.forEach(r => r.forEach(v => { lo = Math.min(lo, v);
                                     hi = Math.max(hi, v); }));
  const rng = hi - lo + 1e-9;
  return rows.map(r => r.map(v => (v - lo) / rng));
}

function drawSeriesChart(canvas, series, colors) {
  const ctx = canvas.getContext("2d");
  canvas.width = canvas.clientWidth; canvas.height = 90;
  ctx.clearRect(0, 0, canvas.width, canvas.height);
  series.forEach((data, si) => {
    if (data.length < 2) return;
    const lo = Math.min(...data), hi = Math.max(...data);
    ctx.strokeStyle = colors[si]; ctx.beginPath();
    data.forEach((l, i) => {
      const x = i / (data.length - 1) * (canvas.width - 8) + 4;
      const y = canvas.height - 6 -
        (l - lo) / (hi - lo + 1e-9) * (canvas.height - 12);
      i ? ctx.lineTo(x, y) : ctx.moveTo(x, y);
    });
    ctx.stroke();
    ctx.fillStyle = colors[si]; ctx.font = "10px monospace";
    ctx.fillText(data[data.length - 1].toFixed(3),
                 canvas.width - 48, 12 + si * 12);
  });
}

function drawAll() {
  drawSeriesChart($("loss"), [losses, gnorms], ["#8ecbff", "#c98"]);
  // QKV: per-token strips (QKVVectors) + the raw matrix (QKVMatrix).
  const qkvRows = ["qkv_q", "qkv_k", "qkv_v"].map(sitePayload)
    .filter(Boolean).map(m => flat2d(m.result));
  if (qkvRows.length) {
    const rows = [].concat(...qkvRows);
    const dim = rows[0].length;
    mount("qkv_vectors", QKVVectors({
      colors: dimColors(dim), values: rows.flat(), dim }));
    const norm = normalize01(rows);
    mount("qkv_matrix", QKVMatrix({
      rows: norm.length, cols: dim,
      colors: norm.flat().map(() => [0.2, 0.45, 0.95]),
      values: norm.flat() }));
  }
  const att = sitePayload("attention_probs");
  if (att) {
    const rows = headSlice(att.result);
    mount("attn", AttentionMatrix({
      size: rows.length, color: [0.18, 0.44, 0.92],
      values: rows.map(r => r.slice(0, rows.length)),
      tokens: null, layer_id: att.layer_id }));
  }
  const ctxp = sitePayload("context");
  if (ctxp) {
    const rows = normalize01(flat2d(ctxp.result));
    mount("ctx", QKVMatrix({
      rows: rows.length, cols: rows[0].length,
      colors: rows.flat().map(() => [0.85, 0.45, 0.2]),
      values: rows.flat() }));
  }
  const mlpPanels = [["mlp1", [0.2, 0.7, 0.4]], ["mlp2", [0.7, 0.3, 0.7]]];
  const mlpBox = document.createElement("div");
  for (const [site, color] of mlpPanels) {
    const m = sitePayload(site);
    if (!m) continue;
    const rows = flat2d(m.result);
    mlpBox.appendChild(MLPVectors({
      color, values: rows.flat(), dim: rows[0].length }));
  }
  if (mlpBox.childNodes.length) mount("mlp", mlpBox);
  const res = sitePayload("result");
  if (res) {
    const rows = flat2d(res.result);
    const last = rows[rows.length - 1];
    mount("probs", ColoredVector({
      length: last.length,
      colors: last.map((_, i) => dimColors(last.length)[i]),
      values: last }));
  }
  if (latest["pca"]) {
    // Training server emits {"type": "pca", points: [[x, y], ...]} for
    // one flattened batch; PCAPlot takes [batch][token][2].
    mount("pca", PCAPlot({
      values: [latest["pca"].points], layerId: $("sel_layer").value || 0,
      tokens: null }));
  }
}

// ---- inference mode ------------------------------------------------------
let genTokens = [], selectedTok = -1, iws = null;
const ilatest = {};

$("gen").onclick = () => {
  const url = $("iws").value ||
              `ws://${location.hostname}:5000/ws`;
  // One live generation socket at a time: a second click aborts the
  // stream in flight instead of interleaving two runs' tokens.
  if (iws && iws.readyState <= 1) { try { iws.close(); } catch (e) {} }
  try { iws = new WebSocket(url); }
  catch (e) { $("istatus").textContent = "bad ws url"; return; }
  const sock = iws;   // handlers ignore events from superseded sockets
  genTokens = []; selectedTok = -1;
  renderGenText(); renderCandidates();
  $("istatus").textContent = "connecting...";
  sock.onopen = () => {
    $("istatus").textContent = "generating...";
    const layers = $("ilayers").value.split(",")
      .map(s => parseInt(s.trim())).filter(Number.isFinite);
    const vis = {};
    if ($("if_qkv").checked) vis["QKV_mat_mul"] = layers;
    if ($("if_attn").checked) vis["RawAttentionScore"] = layers;
    if ($("if_cands").checked) vis["Result"] = [0]; // top-20 candidates
    const req = {
      prompts: [$("prompt").value],
      tokens_to_generate: parseInt($("ntok").value) || 16,
      temperature: parseFloat($("temp").value) || 0,
      top_k: parseInt($("topk").value) || 0,
    };
    // Omit visualization entirely when nothing is requested so the
    // server takes the fast no-retrace path.
    if (Object.keys(vis).length) req.visualization = vis;
    sock.send(JSON.stringify(req));
  };
  sock.onerror = () => { if (sock === iws)
    $("istatus").textContent = "connection failed"; };
  sock.onmessage = ev => {
    if (sock !== iws) return;   // superseded by a newer generation
    const msg = JSON.parse(ev.data);
    if (msg.type === "token") {
      genTokens.push(msg);
      if (selectedTok < 0) { selectedTok = 0; }
      renderGenText();
      renderCandidates();
    } else if (msg.type === "done") {
      $("istatus").textContent = `done (${genTokens.length} tokens)`;
      sock.close();
    } else if (msg.type === "error") {
      $("istatus").textContent = "error: " + msg.message;
      sock.close();
    } else if (msg.site) {
      ilatest[msg.site] = msg;
      drawInferPanels();
    }
  };
};

function renderGenText() {
  const el = $("gen_text");
  el.innerHTML = "";
  const pr = document.createElement("span");
  pr.className = "prompt"; pr.textContent = $("prompt").value;
  el.appendChild(pr);
  genTokens.forEach((t, i) => {
    const s = document.createElement("span");
    s.className = "tok" + (i === selectedTok ? " sel" : "");
    s.textContent = t.text ?? String(t.token);
    s.title = `step ${t.step} id ${t.token}`;
    s.onclick = () => { selectedTok = i; renderGenText();
                        renderCandidates(); };
    el.appendChild(s);
  });
}

function renderCandidates() {
  // Reference OutputProbs: top-k candidates with the sampled token
  // highlighted — rendered by the named component counterpart.
  const t = genTokens[selectedTok];
  $("cand_tok").textContent = t
    ? `— step ${t.step}: "${t.text ?? t.token}"` : "";
  if (!t || !t.candidates) { mount("cands", HelloWorld({})); return; }
  mount("cands", OutputProbs({ data: {
    probs: t.candidates.map(c => ({
      logit: 0, id: c.token, token: c.text ?? String(c.token),
      probability: c.prob })),
    sampled: { logit: 0, id: t.token, token: t.text ?? String(t.token),
               probability: (t.candidates.find(c => c.token === t.token)
                             || { prob: 0 }).prob },
  } }));
}

function drawInferPanels() {
  const q = ["qkv_q", "qkv_k", "qkv_v"].map(s => ilatest[s])
    .filter(Boolean).map(m => flat2d(m.result));
  if (q.length) {
    const rows = [].concat(...q);
    mount("iqkv", QKVVectors({
      colors: dimColors(rows[0].length), values: rows.flat(),
      dim: rows[0].length }));
  }
  if (ilatest["attention_probs"]) {
    const rows = flat2d(ilatest["attention_probs"].result);
    mount("iattn", AttentionMatrix({
      size: rows.length, color: [0.18, 0.44, 0.92],
      values: rows.map(r => r.slice(0, rows.length)),
      tokens: genTokens.map((t, i) => ({ id: t.token,
                                         token: t.text ?? String(t.token) })),
      layer_id: ilatest["attention_probs"].layer_id }));
  }
}

connect();
