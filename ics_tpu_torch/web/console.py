"""Interactive API console served at /docs (VERDICT r2 item 6).

The reference's documented test harness is FastAPI's Swagger UI
(``reference/README.md:12``): log in with the Authorize button, then
exercise any endpoint from the browser. This is the hand-built equivalent —
one self-contained HTML page (no CDN, works offline) that reads
``/openapi.json``, renders a form per operation (path params, query
params, JSON body pre-filled from the schema, file uploads for multipart)
and sends authenticated requests through the cookie flow
(``POST /auth/login`` sets the auth cookie; same-origin fetches carry it).
"""

CONSOLE_HTML = """<!doctype html>
<html lang="pt-BR"><head><meta charset="utf-8">
<title>ics_tpu_torch — Console da API</title>
<style>
 body{font-family:system-ui,sans-serif;margin:0;background:#f6f7f9;color:#1c2733}
 header{background:#12283f;color:#fff;padding:.8rem 1.2rem;display:flex;
        gap:1rem;align-items:center;flex-wrap:wrap;position:sticky;top:0;z-index:2}
 header h1{font-size:1.05rem;margin:0 1rem 0 0;font-weight:600}
 header input{padding:.35rem .5rem;border:none;border-radius:4px}
 header button{padding:.38rem .8rem;border:none;border-radius:4px;
               background:#2e7d32;color:#fff;cursor:pointer}
 #who{font-size:.85rem;opacity:.9}
 main{max-width:1060px;margin:1rem auto;padding:0 1rem}
 .tag{margin:1.1rem 0 .4rem;font-size:1rem;font-weight:700;color:#12283f;
      text-transform:capitalize}
 .op{background:#fff;border:1px solid #dfe3e8;border-radius:6px;
     margin:.35rem 0;overflow:hidden}
 .op>summary{padding:.5rem .8rem;cursor:pointer;display:flex;gap:.7rem;
             align-items:center;list-style:none}
 .op>summary::-webkit-details-marker{display:none}
 .m{font-weight:700;font-size:.72rem;padding:.18rem .5rem;border-radius:4px;
    color:#fff;min-width:3.2rem;text-align:center}
 .GET{background:#1e6fbf}.POST{background:#2e7d32}.PATCH{background:#b07d15}
 .PUT{background:#b07d15}.DELETE{background:#b3362c}
 .path{font-family:ui-monospace,monospace;font-size:.88rem}
 .sum{color:#5c6b7a;font-size:.82rem;margin-left:auto;text-align:right}
 .body{padding:.7rem .9rem;border-top:1px solid #eef1f4}
 .body label{display:block;font-size:.78rem;color:#44525f;margin:.45rem 0 .15rem}
 .body input[type=text],.body textarea{width:100%;box-sizing:border-box;
   padding:.4rem .5rem;border:1px solid #c6ccd4;border-radius:4px;
   font-family:ui-monospace,monospace;font-size:.85rem}
 .body textarea{min-height:7.5rem}
 .exec{margin-top:.6rem;padding:.42rem 1rem;border:none;border-radius:4px;
       background:#12283f;color:#fff;cursor:pointer}
 .result{margin-top:.6rem;display:none}
 .status{font-weight:700;font-size:.85rem}
 .status.ok{color:#2e7d32}.status.err{color:#b3362c}
 pre{background:#0f1820;color:#d8e4ef;padding:.7rem;border-radius:6px;
     overflow:auto;max-height:22rem;font-size:.8rem}
 .schema{font-size:.75rem;color:#5c6b7a;margin-top:.3rem}
</style></head><body>
<header>
 <h1>ics_tpu_torch — Console da API</h1>
 <input id="lu" type="text" placeholder="email" autocomplete="username">
 <input id="lp" type="password" placeholder="senha" autocomplete="current-password">
 <button onclick="login()">Entrar</button>
 <button style="background:#5c6b7a" onclick="logout()">Sair</button>
 <span id="who"></span>
</header>
<main id="ops">carregando /openapi.json…</main>
<script>
let SPEC = null;
function resolve(s){
  if (s && s.$ref) {
    const name = s.$ref.split('/').pop();
    return resolve((SPEC.components && SPEC.components.schemas || {})[name] || {});
  }
  return s || {};
}
function skeleton(s, depth){
  s = resolve(s); depth = depth || 0;
  if (depth > 6) return null;
  if (s.type === 'object' || s.properties){
    const o = {};
    for (const [k, v] of Object.entries(s.properties || {}))
      o[k] = skeleton(v, depth + 1);
    return o;
  }
  if (s.type === 'array') return [skeleton(s.items, depth + 1)];
  if (s.anyOf) return skeleton(s.anyOf.find(x => x.type !== 'null') || s.anyOf[0], depth + 1);
  if (s.default !== undefined) return s.default;
  if (s.type === 'integer' || s.type === 'number') return 0;
  if (s.type === 'boolean') return false;
  if (s.format === 'date-time') return new Date().toISOString();
  return "";
}
async function login(){
  const fd = new FormData();
  fd.append('username', document.getElementById('lu').value);
  fd.append('password', document.getElementById('lp').value);
  const r = await fetch('/auth/login', {method:'POST', body:fd, credentials:'same-origin'});
  const who = document.getElementById('who');
  if (r.ok){ const j = await r.json(); who.textContent = 'autenticado (' + (j.user_type||'') + ')'; }
  else { who.textContent = 'falha: HTTP ' + r.status; }
}
async function logout(){
  await fetch('/auth/logout', {method:'POST', credentials:'same-origin'});
  document.getElementById('who').textContent = 'sessão encerrada';
}
function esc(t){ return (t||'').replace(/&/g,'&amp;').replace(/</g,'&lt;'); }
function opId(path, m){ return (m + path).replace(/[^a-zA-Z0-9]/g, '_'); }
function render(){
  const groups = {};
  for (const [path, methods] of Object.entries(SPEC.paths)){
    for (const [m, op] of Object.entries(methods)){
      const tag = (path.split('/')[1] || 'raiz') || 'raiz';
      (groups[tag] = groups[tag] || []).push([path, m.toUpperCase(), op]);
    }
  }
  const out = [];
  for (const tag of Object.keys(groups).sort()){
    out.push('<div class="tag">' + esc(tag) + '</div>');
    for (const [path, m, op] of groups[tag].sort((x, y) => x[0] < y[0] ? -1 : 1)){
      const id = opId(path, m);
      out.push('<details class="op"><summary>' +
        '<span class="m ' + m + '">' + m + '</span>' +
        '<span class="path">' + esc(path) + '</span>' +
        '<span class="sum">' + esc(op.summary || '') + '</span></summary>' +
        '<div class="body" id="b_' + id + '">' + form(path, m, op, id) + '</div></details>');
    }
  }
  document.getElementById('ops').innerHTML = out.join('');
}
function form(path, m, op, id){
  const h = [];
  for (const p of (op.parameters || [])){
    h.push('<label>' + esc(p.name) + ' <i>(' + p.in + (p.required ? ', obrigatório' : '') + ')</i>' +
      (p.description ? ' — ' + esc(p.description) : '') + '</label>' +
      '<input type="text" id="p_' + id + '_' + p.in + '_' + esc(p.name) + '">');
  }
  const rb = op.requestBody && op.requestBody.content;
  if (rb){
    const ct = Object.keys(rb)[0];
    const schema = resolve(rb[ct].schema);
    if (ct === 'multipart/form-data' || ct === 'application/x-www-form-urlencoded'){
      for (const [k, v] of Object.entries(schema.properties || {})){
        const rs = resolve(v);
        if (rs.format === 'binary')
          h.push('<label>' + esc(k) + ' (arquivo)</label><input type="file" id="f_' + id + '_' + esc(k) + '" multiple>');
        else
          h.push('<label>' + esc(k) + '</label><input type="text" id="ff_' + id + '_' + esc(k) + '">');
      }
      h.push('<input type="hidden" id="ct_' + id + '" value="' + ct + '">');
    } else {
      h.push('<label>corpo (application/json)</label>' +
        '<textarea id="j_' + id + '">' + esc(JSON.stringify(skeleton(rb[ct].schema), null, 2)) + '</textarea>');
    }
  }
  h.push('<button class="exec" onclick="exec(\\'' + path + '\\',\\'' + m + '\\',\\'' + id + '\\')">Enviar</button>');
  h.push('<div class="result" id="r_' + id + '"><span class="status" id="s_' + id + '"></span>' +
         '<pre id="o_' + id + '"></pre></div>');
  return h.join('');
}
async function exec(path, m, id){
  let url = path;
  for (const mt of path.matchAll(/{([^}:]+)(?::[^}]*)?}/g)){
    const el = document.getElementById('p_' + id + '_path_' + mt[1]);
    // function replacement: a plain string re-expands $-patterns
    // ($&, $`, $') typed by the user and corrupts the URL
    url = url.replace(mt[0], () => encodeURIComponent(el ? el.value : ''));
  }
  const qs = [];
  for (const el of document.querySelectorAll('[id^="p_' + id + '_query_"]')){
    if (el.value) qs.push(encodeURIComponent(el.id.split('_query_')[1]) + '=' + encodeURIComponent(el.value));
  }
  if (qs.length) url += '?' + qs.join('&');
  const init = {method: m, credentials: 'same-origin', headers: {}};
  const ctEl = document.getElementById('ct_' + id);
  const jEl = document.getElementById('j_' + id);
  if (ctEl && ctEl.value === 'multipart/form-data'){
    const fd = new FormData();
    // slice off the 'f_<id>_' prefix — split('_').pop() truncated any
    // field name containing an underscore to its last segment
    for (const f of document.querySelectorAll('[id^="f_' + id + '_"]'))
      for (const file of f.files) fd.append(f.id.slice(('f_' + id + '_').length), file);
    for (const t of document.querySelectorAll('[id^="ff_' + id + '_"]'))
      if (t.value) fd.append(t.id.slice(('ff_' + id + '_').length), t.value);
    init.body = fd;
  } else if (ctEl){
    const fd = new URLSearchParams();
    for (const t of document.querySelectorAll('[id^="ff_' + id + '_"]'))
      fd.append(t.id.slice(('ff_' + id + '_').length), t.value);
    init.body = fd;
  } else if (jEl && ['POST','PUT','PATCH','DELETE'].includes(m)){
    if (jEl.value.trim()){
      init.body = jEl.value; init.headers['Content-Type'] = 'application/json';
    }
  }
  const sEl = document.getElementById('s_' + id), oEl = document.getElementById('o_' + id);
  document.getElementById('r_' + id).style.display = 'block';
  sEl.textContent = '…'; oEl.textContent = '';
  try {
    const r = await fetch(url, init);
    sEl.textContent = 'HTTP ' + r.status;
    sEl.className = 'status ' + (r.ok ? 'ok' : 'err');
    const ct = r.headers.get('content-type') || '';
    if (ct.includes('json')) oEl.textContent = JSON.stringify(await r.json(), null, 2);
    else if (ct.startsWith('image/')){
      const b = await r.blob();
      oEl.textContent = ct + ', ' + b.size + ' bytes';
    } else oEl.textContent = (await r.text()).slice(0, 20000);
  } catch (e){
    sEl.textContent = 'erro'; sEl.className = 'status err';
    oEl.textContent = String(e);
  }
}
fetch('/openapi.json').then(r => r.json()).then(s => { SPEC = s; render(); })
  .catch(e => { document.getElementById('ops').textContent = 'falha ao carregar /openapi.json: ' + e; });
</script></body></html>
"""


def build_openapi(app, title: str, version: str) -> dict:
    """OpenAPI 3.0 document from the live router + the contracts table
    (``ics_tpu_torch.api.openapi_contracts``): path/query parameters, request
    bodies (JSON/form/multipart) and 200-response schemas with pydantic
    component schemas under ``#/components/schemas``."""
    import re

    from ics_tpu_torch.api.openapi_contracts import CONTRACTS

    components: dict = {}

    def schema_ref(model_or_dict):
        if model_or_dict is None:
            return None
        if isinstance(model_or_dict, dict):
            return model_or_dict
        name = model_or_dict.__name__
        if name not in components:
            sch = model_or_dict.model_json_schema(
                ref_template="#/components/schemas/{model}"
            )
            components.update(sch.pop("$defs", {}))
            components[name] = sch
        return {"$ref": f"#/components/schemas/{name}"}

    media = {
        "json": "application/json",
        "form": "application/x-www-form-urlencoded",
        "multipart": "multipart/form-data",
    }
    paths: dict = {}
    for route in app.router.routes:
        entry = paths.setdefault(route.path, {})
        path_params = re.findall(r"{([^}:]+)(?::[^}]*)?}", route.path)
        for method in route.methods:
            doc = (route.handler.__doc__ or "").strip()
            contract = CONTRACTS.get((method, route.path), {})
            op: dict = {
                "summary": doc.splitlines()[0] if doc else route.handler.__name__,
                "responses": {"200": {"description": "OK"}},
            }
            params = [
                {"name": p, "in": "path", "required": True,
                 "schema": {"type": "string"}}
                for p in path_params
            ]
            for qname, qdesc in (contract.get("query") or {}).items():
                params.append(
                    {"name": qname, "in": "query", "required": False,
                     "description": qdesc, "schema": {"type": "string"}}
                )
            if params:
                op["parameters"] = params
            req = schema_ref(contract.get("request"))
            if req is not None:
                op["requestBody"] = {
                    "required": True,
                    "content": {
                        media[contract.get("body", "json")]: {"schema": req}
                    },
                }
            resp = schema_ref(contract.get("response"))
            if resp is not None:
                if contract.get("response_list"):
                    resp = {"type": "array", "items": resp}
                op["responses"]["200"] = {
                    "description": "OK",
                    "content": {"application/json": {"schema": resp}},
                }
            entry[method.lower()] = op
    return {
        "openapi": "3.0.0",
        "info": {"title": title, "version": version},
        "paths": paths,
        "components": {"schemas": components},
    }
