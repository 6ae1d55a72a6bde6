"""Operator dashboard (``GET /monitor/painel``) — self-contained HTML (a copy
of ``ics_tpu/web/painel.py``'s page; the port's ``/monitor/status`` answers
the keys it reads).

Complements the interactive ``/docs`` console (``web/console.py``):
the console is for CALLING the API; this page is for WATCHING it run —
sync status, engine throughput/latency/lanes, hedging counters and the
training job list, with a live SSE loss sparkline for a running job
(GET /treinamento/jobs/{id}/stream). No CDN, no dependencies; admin
endpoints show a login hint when the session cookie is absent.
"""

PAINEL_HTML = """<!doctype html>
<html lang="pt-BR"><head><meta charset="utf-8">
<title>Painel — ICS TPU</title>
<style>
 body{font:14px/1.45 system-ui,sans-serif;margin:0;background:#0f1419;color:#d6dbe1}
 header{padding:14px 20px;background:#161c23;border-bottom:1px solid #283038}
 header h1{font-size:16px;margin:0;display:inline}
 header small{color:#8b98a5;margin-left:12px}
 main{display:grid;grid-template-columns:repeat(auto-fit,minmax(320px,1fr));gap:14px;padding:16px 20px}
 section{background:#161c23;border:1px solid #283038;border-radius:8px;padding:12px 14px}
 h2{font-size:13px;margin:0 0 8px;color:#9fb0c0;text-transform:uppercase;letter-spacing:.4px}
 table{width:100%;border-collapse:collapse;font-size:13px}
 td{padding:2px 4px;border-bottom:1px solid #1d242c}
 td:last-child{text-align:right;font-variant-numeric:tabular-nums;color:#e8eef4}
 .ok{color:#7dd98a}.bad{color:#ff8181}.dim{color:#8b98a5}
 svg{display:block;width:100%;height:54px;margin-top:6px}
 polyline{fill:none;stroke:#5aa7ff;stroke-width:1.5}
 a{color:#5aa7ff}
 #jobs td:first-child{font-family:ui-monospace,monospace;font-size:12px}
</style></head><body>
<header><h1>Painel ICS-TPU</h1>
 <small id="ts" class="dim"></small>
 <small><a href="/docs">console da API →</a></small></header>
<main>
 <section><h2>Sincronização NextCloud</h2><table id="sync"></table></section>
 <section><h2>Engine TPU</h2><table id="tpu"></table></section>
 <section><h2>Latência de serving</h2><table id="lat"></table></section>
 <section><h2>Lanes de decodificação</h2><table id="lanes"></table></section>
 <section><h2>Jobs de treino <span id="jobs-note" class="dim"></span></h2>
  <table id="jobs"></table>
  <svg id="spark" viewBox="0 0 200 50" preserveAspectRatio="none"></svg>
  <div id="spark-label" class="dim"></div></section>
 <section><h2>Hedging / réplicas</h2><table id="hedge"></table></section>
</main>
<script>
function esc(s){
  // server-derived strings (sync error text can embed NextCloud-side
  // content) must never reach innerHTML unescaped
  return String(s).replace(/[&<>"']/g, c => ({'&':'&amp;','<':'&lt;',
    '>':'&gt;','"':'&quot;',"'":'&#39;'}[c]));
}
function rows(el, pairs){
  document.getElementById(el).innerHTML = pairs.map(
    ([k, v, cls]) =>
      `<tr><td>${esc(k)}</td><td class="${cls||''}">${esc(v)}</td></tr>`
  ).join('');
}
function fmt(x){
  if (x === null || x === undefined) return '—';
  if (typeof x === 'number') return x.toLocaleString('pt-BR');
  return String(x);
}
async function tick(){
  document.getElementById('ts').textContent =
    'atualizado ' + new Date().toLocaleTimeString('pt-BR');
  try {
    const s = await (await fetch('/monitor/status')).json();
    const sy = s.sync || {}, tp = s.tpu || {};
    rows('sync', sy.enabled === false
      ? [['estado', 'desabilitado', 'dim']]
      : Object.entries(sy).map(([k, v]) => [k, fmt(v)]));
    rows('tpu', tp.enabled === false
      ? [['estado', 'desabilitado', 'dim']]
      : [['modelo', fmt(tp.model)], ['imagens', fmt(tp.images)],
         ['batches', fmt(tp.batches)], ['compilações', fmt(tp.compiles)],
         ['ms/batch (médio)', fmt(tp.avg_device_ms)],
         ['buckets', fmt((tp.buckets||[]).join(', '))]]);
    const lat = tp.latency || {};
    rows('lat', Object.keys(lat).length
      ? Object.entries(lat).map(([k, v]) => [k, fmt(v)])
      : [['sem tráfego ainda', '—', 'dim']]);
    const laneKeys = Object.keys(tp).filter(
      k => k.startsWith('device_decoded') || k === 'host_decoded');
    rows('lanes', laneKeys.length
      ? laneKeys.map(k => [k, fmt(tp[k])])
      : [['sem decodificações ainda', '—', 'dim']]);
    const hd = tp.hedging;
    rows('hedge', hd
      ? Object.entries(hd).map(([k, v]) => [k, fmt(v)])
      : [['réplica única', '—', 'dim']]);
  } catch (e) { rows('sync', [['erro', e, 'bad']]); }
  try {
    const r = await fetch('/treinamento/jobs');
    if (r.status === 401 || r.status === 403) {
      document.getElementById('jobs-note').textContent =
        '(faça login como admin no /docs)';
      rows('jobs', []);
      attachStream(null);  // session expired: close the stale SSE too
    } else if (r.ok) {
      const jobs = (await r.json()).jobs || [];
      document.getElementById('jobs-note').textContent = '';
      rows('jobs', jobs.slice(-6).reverse().map(j => [
        `${j.id_job} ${j.modelo}${j.tipo === 'avaliacao' ? ' (aval)' : ''}`,
        `${j.status} · ${j.passos} passos`,
        j.status === 'concluido' ? 'ok'
          : j.status === 'falhou' ? 'bad' : '']));
      const live = jobs.find(j => j.status === 'executando');
      attachStream(live ? live.id_job : null);
    }
  } catch (e) {}
}
let streaming = null, losses = [];
function attachStream(id){
  if (streaming === id) return;
  if (window._es) { window._es.close(); window._es = null; }
  streaming = id; losses = []; draw();
  document.getElementById('spark-label').textContent =
    id ? `loss ao vivo — job ${id}` : 'nenhum job em execução';
  if (!id) return;
  const es = new EventSource(`/treinamento/jobs/${id}/stream`);
  window._es = es;
  es.addEventListener('passo', e => {
    losses.push(JSON.parse(e.data).loss);
    if (losses.length > 100) losses.shift();
    draw();
  });
  es.addEventListener('fim', () => { es.close(); streaming = null; });
}
function draw(){
  const svg = document.getElementById('spark');
  if (losses.length < 2) { svg.innerHTML = ''; return; }
  const lo = Math.min(...losses), hi = Math.max(...losses);
  const pts = losses.map((v, i) =>
    `${(i / (losses.length - 1)) * 200},` +
    `${48 - ((v - lo) / (hi - lo || 1)) * 44}`).join(' ');
  svg.innerHTML = `<polyline points="${pts}"/>`;
}
tick(); setInterval(tick, 3000);
</script></body></html>
"""
