/* mcos_tpu desk — vanilla-JS client of the pricing API.
 *
 * Role of the reference's js/app.js + js/charts.js, rebuilt from scratch:
 * no Chart.js CDN (zero-egress deployments), one tiny canvas plotting core,
 * and the convergence chart is REAL (POST /api/convergence prefix means —
 * the reference fakes it from a single price, js/app.js:415-420).
 */
"use strict";

const $ = (id) => document.getElementById(id);
const api = (path, body) =>
  fetch(path, body === undefined ? {} : {
    method: "POST",
    headers: { "Content-Type": "application/json" },
    body: JSON.stringify(body),
  }).then(async (r) => {
    if (!r.ok) throw new Error((await r.text()).slice(0, 300));
    return r.json();
  });

/* ── SVJ parameter sliders ────────────────────────────────────────────── */
const PARAMS = [
  ["kappa",   "κ",  0.1, 15,   0.05, 3.0],
  ["theta",   "θ",  0.005, 0.5, 0.005, 0.04],
  ["xi",      "ξ",  0.05, 3,   0.01, 0.5],
  ["rho",     "ρ",  -0.99, 0,  0.01, -0.7],
  ["v0",      "v₀", 0.005, 0.5, 0.005, 0.04],
  ["lambda_j","λ",  0, 10,     0.1,  1.0],
  ["mu_j",    "μⱼ", -0.2, 0.05, 0.005, -0.05],
  ["sigma_j", "σⱼ", 0.01, 0.5, 0.01, 0.10],
];

function buildSliders() {
  const host = $("sliders");
  for (const [key, label, lo, hi, step, init] of PARAMS) {
    const row = document.createElement("div");
    row.className = "slider-row";
    row.innerHTML = `<span>${label}</span>
      <input type="range" id="p-${key}" min="${lo}" max="${hi}"
             step="${step}" value="${init}">
      <span class="val" id="pv-${key}">${init}</span>`;
    host.appendChild(row);
    row.querySelector("input").addEventListener("input", (e) => {
      $(`pv-${key}`).textContent = Number(e.target.value).toFixed(3);
    });
  }
}

const modelParams = () =>
  Object.fromEntries(PARAMS.map(([k]) => [k, Number($(`p-${k}`).value)]));

/* ── tiny canvas plotting core ────────────────────────────────────────── */
const COLORS = { line: "#4fd1c5", alt: "#f6ad55", dim: "#8a94a6",
                 grid: "#2a3342", band: "rgba(79,209,197,0.15)",
                 up: "#68d391", down: "#fc8181" };

function frame(canvas, xs, ys) {
  const ctx = canvas.getContext("2d");
  const W = canvas.width, H = canvas.height, pad = { l: 54, r: 12, t: 10, b: 24 };
  ctx.clearRect(0, 0, W, H);
  const xmin = Math.min(...xs), xmax = Math.max(...xs);
  const ymin = Math.min(...ys), ymax = Math.max(...ys);
  const yspan = (ymax - ymin) || 1;
  const x = (v) => pad.l + ((v - xmin) / ((xmax - xmin) || 1)) * (W - pad.l - pad.r);
  const y = (v) => H - pad.b - ((v - ymin + 0.05 * yspan) / (1.1 * yspan)) * (H - pad.t - pad.b);
  // gridlines + labels
  ctx.strokeStyle = COLORS.grid; ctx.fillStyle = COLORS.dim;
  ctx.font = "11px monospace"; ctx.lineWidth = 1;
  for (let i = 0; i <= 4; i++) {
    const v = ymin + (i / 4) * yspan, py = y(v);
    ctx.beginPath(); ctx.moveTo(pad.l, py); ctx.lineTo(W - pad.r, py); ctx.stroke();
    ctx.fillText(fmt(v), 4, py + 4);
  }
  ctx.fillText(fmt(xmin), pad.l, H - 6);
  ctx.fillText(fmt(xmax), W - pad.r - 40, H - 6);
  return { ctx, x, y };
}

const fmt = (v) => Math.abs(v) >= 1000 ? v.toFixed(0)
  : Math.abs(v) >= 10 ? v.toFixed(1) : v.toFixed(3);

function polyline(f, xs, ys, color, width = 1.5) {
  f.ctx.strokeStyle = color; f.ctx.lineWidth = width; f.ctx.beginPath();
  xs.forEach((xv, i) => i ? f.ctx.lineTo(f.x(xv), f.y(ys[i]))
                          : f.ctx.moveTo(f.x(xv), f.y(ys[i])));
  f.ctx.stroke();
}

function hline(f, yv, color, dash = [5, 4]) {
  f.ctx.save(); f.ctx.setLineDash(dash); f.ctx.strokeStyle = color;
  f.ctx.beginPath();
  f.ctx.moveTo(f.x.range ? 0 : 54, f.y(yv));
  f.ctx.lineTo(f.ctx.canvas.width - 12, f.y(yv));
  f.ctx.stroke(); f.ctx.restore();
}

// Rounded label pill at (x, y); returns its width so callers can stack them.
function pill(ctx, x, y, text, fg, bg) {
  ctx.save();
  ctx.font = "bold 10px monospace";
  const w = ctx.measureText(text).width + 14, h = 17, r = 5;
  ctx.beginPath();
  ctx.moveTo(x + r, y);
  ctx.arcTo(x + w, y, x + w, y + h, r);
  ctx.arcTo(x + w, y + h, x, y + h, r);
  ctx.arcTo(x, y + h, x, y, r);
  ctx.arcTo(x, y, x + w, y, r);
  ctx.closePath();
  ctx.fillStyle = bg; ctx.fill();
  ctx.strokeStyle = fg; ctx.lineWidth = 1; ctx.stroke();
  ctx.fillStyle = fg; ctx.fillText(text, x + 7, y + 12);
  ctx.restore();
  return w;
}

/* ── charts ───────────────────────────────────────────────────────────── */
let pathAnim = 0; // token: a new run cancels the previous animation

function drawPaths(paths, strike) {
  const canvas = $("chart-paths");
  const steps = paths[0].length;
  const xs = [...Array(steps).keys()];
  const shown = paths.slice(0, 40);
  const bounds = [...shown.flat(), strike];
  const token = ++pathAnim;

  // Animated reveal (role of the reference's renderer, js/charts.js:82-317,
  // rebuilt on our plotting core): each frame redraws the scene up to the
  // current step. Paths are sorted so the ones farthest from the strike land
  // on top, with opacity/width/glow scaling with that distance; live
  // above/below badges and a progress pill track the current frame.
  const perFrame = Math.max(2, Math.ceil(steps / 45));
  let upto = 1;

  function tick() {
    if (token !== pathAnim) return; // superseded by a newer run
    const end = Math.min(upto + perFrame, steps - 1);
    upto = end;
    const f = frame(canvas, xs, bounds);
    const ctx = f.ctx;

    const order = shown.map((p, i) => ({ i, d: Math.abs(p[end] - strike) }));
    const dmax = Math.max(...order.map((o) => o.d), 1e-9);
    order.sort((a, b) => a.d - b.d); // dim near-strike first, extremes on top
    const sxs = xs.slice(0, end + 1);
    for (const { i, d } of order) {
      const p = shown[i], t = Math.min(d / dmax, 1), up = p[end] >= strike;
      ctx.save();
      if (t > 0.85) { // glow only on the most extreme paths
        ctx.shadowColor = up ? "rgba(104,211,145,0.5)" : "rgba(252,129,129,0.5)";
        ctx.shadowBlur = 6;
      }
      const a = 0.22 + 0.5 * t;
      polyline(f, sxs, p.slice(0, end + 1),
               up ? `rgba(104,211,145,${a})` : `rgba(252,129,129,${a})`,
               0.7 + 0.9 * t);
      ctx.restore();
    }
    hline(f, strike, COLORS.alt);

    const above = shown.filter((p) => p[end] >= strike).length;
    const pct = Math.round((100 * above) / shown.length);
    const w1 = pill(ctx, 58, 14, `▲ ${above} above (${pct}%)`,
                    COLORS.up, "rgba(104,211,145,0.12)");
    pill(ctx, 58 + w1 + 6, 14, `▼ ${shown.length - above} below (${100 - pct}%)`,
         COLORS.down, "rgba(252,129,129,0.12)");
    const prog = `step ${end}/${steps - 1}`;
    ctx.font = "bold 10px monospace";
    pill(ctx, canvas.width - 12 - ctx.measureText(prog).width - 14, 14,
         prog, COLORS.dim, "rgba(42,51,66,0.85)");
    const sl = `K ${fmt(strike)}`;
    pill(ctx, canvas.width - 12 - ctx.measureText(sl).width - 14,
         f.y(strike) - 21, sl, COLORS.alt, "rgba(246,173,85,0.12)");

    if (upto < steps - 1) requestAnimationFrame(tick);
  }
  tick();
}

function drawConvergence(conv) {
  const canvas = $("chart-conv");
  const xs = conv.num_paths.map((n) => Math.log10(n));
  const hi = conv.price.map((p, i) => p + 2 * conv.std_error[i]);
  const lo = conv.price.map((p, i) => p - 2 * conv.std_error[i]);
  const f = frame(canvas, xs, [...hi, ...lo]);
  // CI band
  f.ctx.fillStyle = COLORS.band; f.ctx.beginPath();
  xs.forEach((xv, i) => i ? f.ctx.lineTo(f.x(xv), f.y(hi[i]))
                          : f.ctx.moveTo(f.x(xv), f.y(hi[i])));
  [...xs].reverse().forEach((xv, i) =>
    f.ctx.lineTo(f.x(xv), f.y([...lo].reverse()[i])));
  f.ctx.closePath(); f.ctx.fill();
  polyline(f, xs, conv.price, COLORS.line, 2);
  hline(f, conv.price[conv.price.length - 1], COLORS.dim);
}

function drawSmile(smile) {
  const canvas = $("chart-smile");
  const pts = smile.filter((p) => p.iv > 0);
  if (!pts.length) return;
  const f = frame(canvas, pts.map((p) => p.strike), pts.map((p) => p.iv));
  polyline(f, pts.map((p) => p.strike), pts.map((p) => p.iv), COLORS.alt, 2);
}

function drawDensity(den, strike) {
  /* Model-exact terminal density (Breeden–Litzenberger via COS): one
     series, forward and strike as dashed reference verticals. */
  const canvas = $("chart-density");
  if (!den || !den.s || !den.s.length) return;
  const f = frame(canvas, [...den.s, strike], [...den.pdf, 0]);
  const vline = (xv, color) => {
    f.ctx.save(); f.ctx.setLineDash([5, 4]); f.ctx.strokeStyle = color;
    f.ctx.beginPath(); f.ctx.moveTo(f.x(xv), f.y(0));
    f.ctx.lineTo(f.x(xv), f.y(Math.max(...den.pdf)));
    f.ctx.stroke(); f.ctx.restore();
  };
  vline(den.forward, COLORS.dim);
  vline(strike, COLORS.alt);
  polyline(f, den.s, den.pdf, COLORS.line, 2);
}

function drawPayoff(spot, strike, isCall, premium) {
  const canvas = $("chart-payoff");
  const xs = [], ys = [];
  for (let m = 0.7; m <= 1.3001; m += 0.01) {
    const s = spot * m;
    const intrinsic = isCall ? Math.max(s - strike, 0) : Math.max(strike - s, 0);
    xs.push(s); ys.push(intrinsic - premium);
  }
  const f = frame(canvas, xs, ys);
  hline(f, 0, COLORS.dim);
  // color by sign
  for (let i = 1; i < xs.length; i++) {
    polyline(f, [xs[i - 1], xs[i]], [ys[i - 1], ys[i]],
             ys[i] >= 0 ? COLORS.up : COLORS.down, 2);
  }
}

function drawHistogram(samples, strike) {
  const canvas = $("chart-hist");
  const lo = Math.min(...samples), hi = Math.max(...samples);
  const nb = 30, width = (hi - lo) / nb || 1;
  const bins = new Array(nb).fill(0);
  for (const s of samples) {
    bins[Math.min(Math.floor((s - lo) / width), nb - 1)]++;
  }
  const centers = bins.map((_, i) => lo + (i + 0.5) * width);
  const f = frame(canvas, [...centers, strike], [...bins, 0]);
  const bw = (f.x(centers[1]) - f.x(centers[0])) * 0.85;
  bins.forEach((c, i) => {
    f.ctx.fillStyle = centers[i] >= strike ? COLORS.up : COLORS.down;
    f.ctx.globalAlpha = 0.75;
    f.ctx.fillRect(f.x(centers[i]) - bw / 2, f.y(c), bw, f.y(0) - f.y(c));
  });
  f.ctx.globalAlpha = 1;
  hline(f, 0, COLORS.grid, []);
}

/* ── local BS engine (client-side fallback; role of js/engine.js) ─────── */
/* Keeps sensitivity sweeps instant and lets the payoff/sens charts work
 * even if the API is briefly unreachable. Abramowitz-Stegun normal CDF. */
const localBS = {
  ncdf(x) {
    const t = 1 / (1 + 0.2316419 * Math.abs(x));
    const d = 0.3989422804014327 * Math.exp(-x * x / 2);
    let p = d * t * (0.31938153 + t * (-0.356563782 + t * (1.781477937 +
            t * (-1.821255978 + t * 1.330274429))));
    return x >= 0 ? 1 - p : p;
  },
  price(S, K, T, r, q, sigma, isCall) {
    if (T <= 0 || sigma <= 0) {
      const intr = isCall ? S - K : K - S;
      return Math.max(intr, 0);
    }
    const st = sigma * Math.sqrt(T);
    const d1 = (Math.log(S / K) + (r - q + sigma * sigma / 2) * T) / st;
    const d2 = d1 - st;
    const dfq = Math.exp(-q * T), dfr = Math.exp(-r * T);
    return isCall
      ? S * dfq * this.ncdf(d1) - K * dfr * this.ncdf(d2)
      : K * dfr * this.ncdf(-d2) - S * dfq * this.ncdf(-d1);
  },
};

/* Two sweep modes like the reference's tabs (js/engine.js:221-245):
 * "vol" = price vs σ over 5-80%, "strike" = price vs K over 0.7-1.3·S.
 * Both call and put curves are drawn so the sweep answers either side. */
let sensMode = "vol";
let lastSens = null; // remember the last run's contract for tab switches

function drawSensitivity(spot, strike, T, isCall) {
  lastSens = { spot, strike, T, isCall };
  const canvas = $("chart-sens");
  const xs = [], call = [], put = [];
  if (sensMode === "vol") {
    for (let vol = 0.05; vol <= 0.8001; vol += 0.025) {
      xs.push(vol);
      call.push(localBS.price(spot, strike, T, 0.065, 0.012, vol, true));
      put.push(localBS.price(spot, strike, T, 0.065, 0.012, vol, false));
    }
  } else {
    const sigma = Math.sqrt(Number($("p-v0").value));
    for (let m = 0.7; m <= 1.3001; m += 0.02) {
      xs.push(spot * m);
      call.push(localBS.price(spot, spot * m, T, 0.065, 0.012, sigma, true));
      put.push(localBS.price(spot, spot * m, T, 0.065, 0.012, sigma, false));
    }
  }
  const f = frame(canvas, xs, [...call, ...put]);
  polyline(f, xs, call, isCall ? COLORS.line : COLORS.dim, isCall ? 2 : 1.2);
  polyline(f, xs, put, isCall ? COLORS.dim : COLORS.line, isCall ? 1.2 : 2);
  f.ctx.fillStyle = isCall ? COLORS.line : COLORS.dim;
  f.ctx.fillText("call", 60, 18);
  f.ctx.fillStyle = isCall ? COLORS.dim : COLORS.line;
  f.ctx.fillText("put", 100, 18);
}

function setSensMode(mode) {
  sensMode = mode;
  $("sens-vol").classList.toggle("active", mode === "vol");
  $("sens-strike").classList.toggle("active", mode === "strike");
  if (lastSens) {
    drawSensitivity(lastSens.spot, lastSens.strike, lastSens.T,
                    lastSens.isCall);
  }
}

/* ── rough vol + exposure panels ──────────────────────────────────────── */
async function roughSmile() {
  const btn = $("rough-btn");
  btn.disabled = true; btn.textContent = "simulating…";
  const spot = Number($("spot").value);
  const T = Number($("days").value) / 252;
  const moneyness = [];
  for (let m = 0.88; m <= 1.1201; m += 0.02) moneyness.push(Number(m.toFixed(3)));
  try {
    const [rough, svj, skew] = await Promise.all([
      api("/api/rough", {
        spot, T, mode: "smile", moneyness,
        hurst: Number($("r-hurst").value), eta: Number($("r-eta").value),
        rho: Number($("r-rho").value), xi: Number($("p-v0").value),
      }),
      api("/api/smile", { spot, T, params: modelParams() }),
      api("/api/rough", {
        spot, T, mode: "skew",
        hurst: Number($("r-hurst").value), eta: Number($("r-eta").value),
        rho: Number($("r-rho").value), xi: Number($("p-v0").value),
      }),
    ]);
    $("fig-rough").classList.remove("hidden");
    const canvas = $("chart-rough");
    const rpts = rough.strikes
      .map((k, i) => [k, rough.implied_vols[i]])
      .filter(([, v]) => v != null && v > 0);          // IV inversion can fail
    const sv = svj.smile.filter((p) => p.iv > 0);
    const f = frame(canvas, [...rpts.map(([k]) => k), ...sv.map((p) => p.strike)],
                    [...rpts.map(([, v]) => v), ...sv.map((p) => p.iv)]);
    polyline(f, rpts.map(([k]) => k), rpts.map(([, v]) => v),
             COLORS.line, 2);                          // rough
    polyline(f, sv.map((p) => p.strike), sv.map((p) => p.iv),
             COLORS.alt, 2);                           // SVJ
    f.ctx.fillStyle = COLORS.line; f.ctx.fillText("rough", 60, 18);
    f.ctx.fillStyle = COLORS.alt; f.ctx.fillText("SVJ", 110, 18);
    $("rough-skew").textContent =
      `ATM skew ${skew.skew.toFixed(3)} (T^{H-1/2} regime)`;
  } catch (e) { alert(`rough smile failed: ${e.message}`); }
  finally { btn.disabled = false; btn.textContent = "Rough smile + skew"; }
}

async function exposureProfile() {
  const btn = $("exposure-btn");
  btn.disabled = true; btn.textContent = "simulating…";
  const spot = Number($("spot").value);
  const T = Math.max(Number($("days").value) / 252, 0.05);
  try {
    const out = await api("/api/exposure", {
      spots: [spot], sigmas: [Math.sqrt(Number($("p-v0").value))],
      corr: [[1.0]],
      positions: [{ kind: $("is-call").checked ? "call" : "put",
                    strike: Number($("strike").value), T, qty: 1.0 }],
      num_paths: 65536, num_dates: 24,
      hazard_rate: Number($("x-hazard").value),
      lgd: Number($("x-lgd").value),
    });
    $("fig-exposure").classList.remove("hidden");
    const canvas = $("chart-exposure");
    const f = frame(canvas, out.dates, [...out.pfe, ...out.ee, 0]);
    polyline(f, out.dates, out.pfe, COLORS.down, 2);   // PFE 97.5%
    polyline(f, out.dates, out.ee, COLORS.line, 2);    // EE
    f.ctx.fillStyle = COLORS.down; f.ctx.fillText("PFE 97.5%", 60, 18);
    f.ctx.fillStyle = COLORS.line; f.ctx.fillText("EE", 130, 18);
    $("cva-badge").textContent =
      `CVA ${out.credit.cva.toFixed(2)} · EPE ${out.epe.toFixed(2)}`;
  } catch (e) { alert(`exposure failed: ${e.message}`); }
  finally { btn.disabled = false; btn.textContent = "EE / PFE + CVA"; }
}

async function hhwImpact() {
  const btn = $("hhw-btn");
  btn.disabled = true; btn.textContent = "simulating…";
  try {
    const out = await api("/api/hhw", {
      spot: Number($("spot").value),
      strike: Number($("strike").value),
      T: Math.max(Number($("days").value) / 252, 0.05),
      is_call: $("is-call").checked,
      mode: "impact",
      v0: Number($("p-v0").value), theta: Number($("p-theta").value),
      kappa: Number($("p-kappa").value), xi: Number($("p-xi").value),
      rho_sv: Number($("p-rho").value),
      sigma_r: Number($("h-sigr").value),
      rho_sr: Number($("h-rhosr").value),
      a: Number($("h-a").value),
      num_paths: 100000, num_steps: 64,
    });
    const el = $("hhw-out");
    el.classList.remove("hidden");
    el.textContent = `price ${out.price.toFixed(2)} | det-rates ` +
      `${out.price_deterministic_rates.toFixed(2)} | premium ` +
      `${out.stochastic_rates_premium.toFixed(3)}`;
  } catch (e) { alert(`hhw failed: ${e.message}`); }
  finally { btn.disabled = false; btn.textContent = "Rates premium"; }
}

async function autocallPrice() {
  const btn = $("autocall-btn");
  btn.disabled = true; btn.textContent = "simulating…";
  try {
    const out = await api("/api/autocall", {
      T: Math.max(Number($("days").value) / 252, 0.1),
      n_obs: 4,
      autocall_barrier: Number($("ac-barrier").value),
      coupon_barrier: Math.max(Number($("ac-prot").value), 0.75),
      protection_barrier: Number($("ac-prot").value),
      coupon: Number($("ac-coupon").value),
      params: modelParams(),
      num_paths: 100000,
    });
    const el = $("autocall-out");
    el.classList.remove("hidden");
    el.textContent = `note ${out.price.toFixed(4)} | ` +
      `call@1 ${(out.call_prob_by_date[0] * 100).toFixed(0)}% | ` +
      `loss ${(out.loss_prob * 100).toFixed(1)}% | ` +
      `life ${out.expected_life.toFixed(2)}y`;
  } catch (e) { alert(`autocall failed: ${e.message}`); }
  finally { btn.disabled = false; btn.textContent = "Price note"; }
}

async function modelRisk() {
  const btn = $("modelrisk-btn");
  btn.disabled = true; btn.textContent = "pricing the model zoo…";
  try {
    const out = await api("/api/modelrisk", {
      spot: Number($("spot").value),
      strike: Number($("strike").value),
      T: Math.max(Number($("days").value) / 252, 0.02),
      is_call: $("is-call").checked,
      atm_vol: Math.sqrt(Number($("p-v0").value)),
      num_paths: 65536,
    });
    const el = $("modelrisk-out");
    el.classList.remove("hidden");
    const ivs = out.implied_vols;
    el.textContent = Object.keys(out.prices)
      .map((m) => `${m} ${out.prices[m].toFixed(1)}` +
        (ivs[m] != null ? ` (${(ivs[m] * 100).toFixed(1)}%)` : ""))
      .join(" | ") +
      ` — band ${(out.model_risk_band_volpts * 100).toFixed(2)} volpts`;
  } catch (e) { alert(`model risk failed: ${e.message}`); }
  finally { btn.disabled = false;
            btn.textContent = "Price across the model zoo"; }
}

/* ── greeks panel ─────────────────────────────────────────────────────── */
/* Per-Greek explainer metadata (role of the reference's GREEK_META cards,
 * js/app.js:470-516): plain-language INR-denominated tips rendered as a
 * hover tooltip + a magnitude bar under each value. */
const inr = (v) => `₹${Math.abs(v).toFixed(2)}`;
const GREEK_META = {
  delta: {
    label: "Δ delta", color: "#4fd1c5", scale: 1,
    tip: (v, c) => c.isCall
      ? `If ${c.symbol} rises ₹10, this CALL gains ≈ ${inr(v * 10)}.`
      : `If ${c.symbol} falls ₹10, this PUT gains ≈ ${inr(v * 10)}.`,
  },
  gamma: {
    label: "Γ gamma", color: "#63b3ed", scale: 0.01,
    tip: () => "Rate of change of delta — how fast the hedge moves. " +
               "Largest near the money and close to expiry.",
  },
  vega: {
    label: "ν vega/pt", color: "#f6ad55", scale: 30,
    tip: (v) => `A 1-vol-point rise in implied vol moves the premium by ≈ ${inr(v)}.`,
  },
  theta: {
    label: "Θ daily", color: "#fc8181", scale: 8,
    tip: (v) => `Time decay: one calendar day costs ≈ ${inr(v)} of premium ` +
                "(all else equal).",
  },
  rho: {
    label: "ρ rho", color: "#68d391", scale: 30,
    tip: (v, c) => c.isCall
      ? `A 1% RBI rate hike adds ≈ ${inr(v / 100)} to this CALL.`
      : `A 1% RBI rate hike costs ≈ ${inr(v / 100)} on this PUT.`,
  },
  lambda_j: {
    label: "λ jump", color: "#b794f4", scale: 20,
    tip: (v) => `Jump-intensity sensitivity (LR estimator): one extra ` +
                `expected jump per year moves the premium by ≈ ${inr(v)}.`,
  },
};

function renderGreeks(g) {
  const ctx = { symbol: currentSymbol, isCall: $("is-call").checked };
  const rows = [
    ["delta", g.delta.pathwise],
    ["gamma", g.gamma.gamma],
    ["vega", g.vega.vega_per_vol_point],
    ["theta", g.theta.theta_daily / 252],
    ["rho", g.rho.rho],
    ["lambda_j", g.jumps ? g.jumps.lambda_j : NaN],
  ];
  $("greeks").innerHTML = rows.map(([key, v]) => {
    const m = GREEK_META[key];
    const pct = Math.min(Math.abs(v) / m.scale * 100, 100);
    return `
    <div class="card greek" title="${m.tip(Number(v) || 0, ctx)}">
      <div class="card-label" style="color:${m.color}">${m.label}</div>
      <div class="card-value">${Number(v).toPrecision(4)}</div>
      <div class="greek-bar"><span style="width:${pct}%;background:${m.color}"></span></div>
    </div>`;
  }).join("");
}

/* ── searchable symbol picker ─────────────────────────────────────────── */
/* Server-driven universe (GET /api/symbols, 50 NIFTY constituents + index)
 * with search-as-you-type over symbol/name/sector — role of the
 * reference's NIFTY-50 dropdown (js/app.js:67-124). */
let universe = [];
let currentSymbol = "NIFTY";

function renderDropdown(filter) {
  const dd = $("symbol-dropdown");
  const fl = (filter || "").toLowerCase();
  const hits = universe.filter((s) =>
    s.symbol.toLowerCase().includes(fl) ||
    s.name.toLowerCase().includes(fl) ||
    s.sector.toLowerCase().includes(fl));
  dd.innerHTML = hits.length
    ? hits.map((s) => `
        <div class="dd-item${s.symbol === currentSymbol ? " active" : ""}"
             data-symbol="${s.symbol}">
          <span class="dd-sym">${s.symbol}</span>
          <span class="dd-name">${s.name}</span>
          <span class="dd-sector">${s.sector}</span>
        </div>`).join("")
    : '<div class="dd-item dim">No results</div>';
  for (const el of dd.querySelectorAll(".dd-item[data-symbol]")) {
    el.addEventListener("mousedown", (e) => {
      e.preventDefault();
      selectSymbol(el.dataset.symbol);
    });
  }
}

function selectSymbol(symbol) {
  currentSymbol = symbol;
  const s = universe.find((u) => u.symbol === symbol);
  $("symbol-search").value = s ? `${s.symbol} — ${s.name}` : symbol;
  $("symbol-dropdown").classList.add("hidden");
  fetchQuote();
}

function parseDividends() {
  const txt = $("div-sched").value.trim();
  if (!txt) return [];
  return txt.split(",").map((pair) => {
    const [t, amount] = pair.split(":").map(Number);
    if (!(t > 0) || !(amount >= 0)) throw new Error(`bad dividend "${pair}"`);
    return { t, amount };
  });
}

async function dividendReprice() {
  const btn = $("div-btn");
  btn.disabled = true; btn.textContent = "pricing…";
  try {
    const base = {
      spot: Number($("spot").value), strike: Number($("strike").value),
      T: Number($("days").value) / 252, is_call: $("is-call").checked,
      num_paths: 100000, params: modelParams(),
    };
    const divs = parseDividends();
    const kind = $("div-kind").value;
    const [plain, withDivs] = await Promise.all([
      api("/api/price", base),
      api("/api/price", { ...base, dividends: divs, dividend_kind: kind }),
    ]);
    const el = $("div-out");
    el.classList.remove("hidden");
    el.textContent = `no-div ${plain.price.toFixed(2)} | with divs ` +
      `${withDivs.price.toFixed(2)} (${withDivs.dividend_model}) | ` +
      `impact ${(withDivs.price - plain.price).toFixed(2)}`;
  } catch (e) { alert(`dividend pricing failed: ${e.message}`); }
  finally { btn.disabled = false; btn.textContent = "Reprice with dividends"; }
}

async function dividendAmerican() {
  const btn = $("div-am-btn");
  btn.disabled = true; btn.textContent = "LSM…";
  try {
    const base = {
      spot: Number($("spot").value), strike: Number($("strike").value),
      T: Number($("days").value) / 252, is_call: $("is-call").checked,
      num_paths: 100000, params: modelParams(),
      dividends: parseDividends(), dividend_kind: $("div-kind").value,
    };
    const [am, eu] = await Promise.all([
      api("/api/american", base),
      api("/api/price", base),
    ]);
    const el = $("div-out");
    el.classList.remove("hidden");
    el.textContent = `American ${am.price.toFixed(2)} | European ` +
      `${eu.price.toFixed(2)} | early-exercise premium ` +
      `${(am.price - eu.price).toFixed(2)}`;
  } catch (e) { alert(`american failed: ${e.message}`); }
  finally { btn.disabled = false; btn.textContent = "American premium"; }
}

async function volDerivs() {
  const btn = $("vd-btn");
  btn.disabled = true; btn.textContent = "computing…";
  try {
    const T = Number($("vd-T").value);
    const params = modelParams();
    const [vs, vols, fut] = await Promise.all([
      api("/api/volderivs", { kind: "variance_swap", T, params,
                              num_paths: 100000 }),
      api("/api/volderivs", { kind: "vol_swap", T, params,
                              num_paths: 100000 }),
      api("/api/volderivs", { kind: "vix_future", T, params }),
    ]);
    const el = $("vd-out");
    el.classList.remove("hidden");
    el.textContent =
      `var-swap ${(100 * Math.sqrt(vs.fair_variance)).toFixed(2)}² | ` +
      `vol-swap ${(100 * vols.fair_vol_strike).toFixed(2)} (cvx ` +
      `${(100 * vols.convexity_discount).toFixed(2)}) | VIX fut ` +
      `${(100 * fut.future).toFixed(2)} (spot ${(100 * fut.vix_spot).toFixed(2)})`;
  } catch (e) { alert(`vol derivatives failed: ${e.message}`); }
  finally { btn.disabled = false; btn.textContent = "Var/vol swap + VIX"; }
}

async function termStructure() {
  const btn = $("ts-btn");
  btn.disabled = true; btn.textContent = "pricing…";
  try {
    const segments = $("ts-segs").value.split(",").map((tok) => {
      const [t_end, theta, xi, lambda_j] = tok.trim().split(":").map(Number);
      if ([t_end, theta, xi, lambda_j].some((x) => !isFinite(x)))
        throw new Error(`bad segment "${tok.trim()}" (want t:θ:ξ:λ)`);
      return { t_end, theta, xi, lambda_j };
    });
    const T = Number($("days").value) / 252;
    const out = await api("/api/termsvj", {
      spot: Number($("spot").value), T,
      strike: Number($("strike").value),
      is_call: $("is-call").checked,
      params: modelParams(), segments,
      num_paths: Number($("paths").value), num_steps: 256,
    });
    const el = $("ts-out");
    el.classList.remove("hidden");
    const sig = Math.abs(out.price - out.cos_price) /
      Math.max(out.std_error, 1e-12);
    el.textContent = `td MC ${out.price.toFixed(2)} ± ` +
      `${out.std_error.toFixed(2)} | exact COS ` +
      `${out.cos_price.toFixed(2)} (${sig.toFixed(1)}σ) | ` +
      `${out.elapsed_ms} ms`;
  } catch (e) { alert(`term structure failed: ${e.message}`); }
  finally { btn.disabled = false; btn.textContent = "td price vs exact COS"; }
}

async function loadSymbols() {
  try {
    universe = (await api("/api/symbols")).symbols;
  } catch {
    universe = [{ symbol: "NIFTY", name: "NIFTY 50 Index", sector: "Index",
                  price: 22500, vol: 0.14 }];
  }
  const input = $("symbol-search");
  input.value = "NIFTY — NIFTY 50 Index";
  input.addEventListener("focus", () => {
    input.select();
    renderDropdown("");
    $("symbol-dropdown").classList.remove("hidden");
  });
  input.addEventListener("input", () => renderDropdown(input.value));
  input.addEventListener("blur", () =>
    setTimeout(() => $("symbol-dropdown").classList.add("hidden"), 150));
}

async function fetchQuote() {
  try {
    const q = await api(`/api/quote?symbol=${currentSymbol}`);
    $("spot").value = q.price.toFixed(2);
    $("strike").value = (Math.round(q.price / 50) * 50).toFixed(0);
    const badge = $("quote-badge");
    badge.textContent = `${q.source} σ=${(q.volatility * 100).toFixed(1)}%`;
    badge.className = `pill ${q.source === "LIVE" ? "ok" : "warn"}`;
    const vol2 = q.volatility * q.volatility;
    $("p-v0").value = vol2; $("pv-v0").textContent = vol2.toFixed(3);
    $("p-theta").value = vol2; $("pv-theta").textContent = vol2.toFixed(3);
  } catch (e) { console.warn("quote failed", e); }
}

/* Offline fallback (role of the reference's Gen-1 js/engine.js): local GBM
 * MC at σ = √v0 — real paths, a real convergence series, BS greeks — so the
 * desk keeps working with the network pulled. */
function runLocal(body) {
  const r = 0.065, q = 0.012;
  const sigma = Math.sqrt(body.params.v0);
  const pairs = Math.min(Math.max(Math.floor(body.num_paths / 2), 1000), 50000);
  const t0 = performance.now();
  const mc = localMC.price(body.spot, body.strike, body.T, r, q, sigma,
                           body.is_call, pairs, 64);
  const ms = Math.round(performance.now() - t0);
  $("c-price").textContent = mc.price.toFixed(2);
  $("c-se").textContent = `± ${mc.std_error.toFixed(3)}`;
  $("c-bs").textContent = localBS.price(
    body.spot, body.strike, body.T, r, q, sigma, body.is_call).toFixed(2);
  $("c-ms").textContent = `${ms} ms LOCAL`;
  drawPaths(mc.sample_paths, body.strike);
  drawConvergence(localMC.convergence(mc.pay, mc.disc));
  const smile = [];
  for (let m = 0.85; m <= 1.1501; m += 0.025) {
    smile.push({ strike: body.spot * m, iv: sigma, price: 0 });
  }
  drawSmile(smile);
  drawPayoff(body.spot, body.strike, body.is_call, mc.price);
  drawHistogram(Array.from(mc.terminals.slice(0, 1024)), body.strike);
  drawSensitivity(body.spot, body.strike, body.T, body.is_call);
  renderGreeks(localBSGreeks(body.spot, body.strike, body.T, r, q, sigma,
                             body.is_call));
  const badge = $("status");
  badge.textContent = "LOCAL engine (API unreachable)";
  badge.className = "pill warn";
}

async function run() {
  const btn = $("run");
  btn.disabled = true; btn.textContent = "pricing…";
  const body = {
    spot: Number($("spot").value),
    strike: Number($("strike").value),
    T: Number($("days").value) / 252,
    is_call: $("is-call").checked,
    num_paths: Number($("paths").value),
    params: modelParams(),
  };
  try {
    const [price, greeks, conv, smile] = await Promise.all([
      api("/api/price", body),
      api("/api/greeks", { ...body, num_paths: Math.min(body.num_paths, 200000) }),
      api("/api/convergence", { ...body, num_paths: Math.min(body.num_paths, 100000) }),
      api("/api/smile", { spot: body.spot, T: body.T, params: body.params,
                          with_density: true }),
    ]);
    $("c-price").textContent = price.price.toFixed(2);
    $("c-se").textContent = `± ${price.std_error.toFixed(3)}`;
    $("c-bs").textContent = (price.bs_ref ?? NaN).toFixed(2);
    $("c-ms").textContent = `${price.elapsed_ms} ms`;
    drawPaths(price.sample_paths, body.strike);
    drawConvergence(conv);
    drawSmile(smile.smile);
    drawDensity(smile.density, body.strike);
    drawPayoff(body.spot, body.strike, body.is_call, price.price);
    if (price.terminal_samples) drawHistogram(price.terminal_samples, body.strike);
    drawSensitivity(body.spot, body.strike, body.T, body.is_call);
    renderGreeks(greeks);
    $("stress-out").classList.add("hidden");
  } catch (e) {
    console.warn("API pricing failed; using the local engine", e);
    try { runLocal(body); }
    catch (e2) { alert(`pricing failed: ${e.message}`); }
  } finally {
    btn.disabled = false; btn.textContent = "Price it";
  }
}

async function stress() {
  const out = $("stress-out");
  out.classList.remove("hidden");
  out.textContent = "running stress ladders…";
  try {
    const rep = await api("/api/stress", {
      spot: Number($("spot").value),
      strike: Number($("strike").value),
      T: Number($("days").value) / 252,
      is_call: $("is-call").checked,
      num_paths: 50000,
      params: modelParams(),
    });
    out.textContent = JSON.stringify(rep, null, 2);
  } catch (e) { out.textContent = `stress failed: ${e.message}`; }
}

/* Risk cube: spot×vol scenario P&L heatmap (/api/stress mode=matrix).
   Diverging encoding — loss→red pole, gain→blue pole, neutral panel gray at
   zero (two hues + neutral midpoint; lightness monotone per arm). Every cell
   carries its value as text (relief channel) plus a full-precision title
   tooltip, so identity is never color-alone. */
const CUBE_POLES = { loss: [230, 103, 103], gain: [57, 135, 229] }; // dark-mode red/blue
const CUBE_BASE = [29, 36, 48]; // --panel2: the neutral "no P&L" midpoint

function cubeColor(pnl, maxAbs) {
  if (!maxAbs || pnl === 0) return `rgb(${CUBE_BASE.join(",")})`;
  const pole = pnl < 0 ? CUBE_POLES.loss : CUBE_POLES.gain;
  const t = 0.15 + 0.45 * Math.min(Math.abs(pnl) / maxAbs, 1);
  const mix = CUBE_BASE.map((b, i) => Math.round(b + (pole[i] - b) * t));
  return `rgb(${mix.join(",")})`;
}

function renderCube(m) {
  const out = $("cube-out");
  const maxAbs = Math.max(...m.pnl.flat().map(Math.abs));
  const cols = m.spot_shocks_pct;
  let html = `<h2>risk cube — P&amp;L vs joint spot × vol shock</h2>
    <table class="cube"><thead><tr><th>vol \\ spot</th>` +
    cols.map((c) => `<th>${c > 0 ? "+" : ""}${c.toFixed(1)}%</th>`).join("") +
    `</tr></thead><tbody>`;
  m.vol_shocks_pts.forEach((v, i) => {
    html += `<tr><th>${v > 0 ? "+" : ""}${v.toFixed(1)}pt</th>`;
    m.pnl[i].forEach((p, j) => {
      html += `<td style="background:${cubeColor(p, maxAbs)}"
        title="spot ${cols[j] > 0 ? "+" : ""}${cols[j]}% (S=${m.spots[j].toFixed(0)}), vol ${v > 0 ? "+" : ""}${v}pt (v0=${m.v0s[i].toFixed(4)})
price ${m.prices[i][j].toFixed(2)}  P&L ${p.toFixed(2)}">${p.toFixed(1)}</td>`;
    });
    html += "</tr>";
  });
  html += `</tbody></table>
    <p class="cube-note">base price ${m.base_price.toFixed(2)} · red = loss,
    blue = gain, panel gray = flat · CRN: one device program, cell-to-cell
    differences are pure scenario effects</p>`;
  out.innerHTML = html;
}

async function riskCube() {
  const out = $("cube-out");
  out.classList.remove("hidden");
  out.textContent = "pricing the spot × vol cube…";
  try {
    const m = await api("/api/stress", {
      spot: Number($("spot").value),
      strike: Number($("strike").value),
      T: Number($("days").value) / 252,
      is_call: $("is-call").checked,
      num_paths: 50000,
      mode: "matrix",
      params: modelParams(),
    });
    renderCube(m);
  } catch (e) { out.textContent = `risk cube failed: ${e.message}`; }
}

async function init() {
  buildSliders();
  loadSymbols();
  try {
    const h = await api("/api/health");
    $("status").textContent = `${h.engine} v${h.version}`;
    $("status").className = "pill ok";
  } catch {
    $("status").textContent = "API unreachable";
    $("status").className = "pill warn";
  }
  $("run").addEventListener("click", run);
  $("stress-btn").addEventListener("click", stress);
  $("cube-btn").addEventListener("click", riskCube);
  $("quote-btn").addEventListener("click", fetchQuote);
  $("sens-vol").addEventListener("click", () => setSensMode("vol"));
  $("sens-strike").addEventListener("click", () => setSensMode("strike"));
  $("rough-btn").addEventListener("click", roughSmile);
  $("exposure-btn").addEventListener("click", exposureProfile);
  $("hhw-btn").addEventListener("click", hhwImpact);
  $("div-btn").addEventListener("click", dividendReprice);
  $("div-am-btn").addEventListener("click", dividendAmerican);
  $("vd-btn").addEventListener("click", volDerivs);
  $("autocall-btn").addEventListener("click", autocallPrice);
  $("modelrisk-btn").addEventListener("click", modelRisk);
  $("ts-btn").addEventListener("click", termStructure);
}

init();
