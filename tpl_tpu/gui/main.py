"""
tplgui: live observability + control surface over the shared stores.

The reference ships an imviz/imdash GUI process that attaches read/write
to the shm stores of the env/planning/control/sim apps (reference:
library/tpl/gui/tplgui, library/tpl/gui/main.py:13-40,
library/tpl/gui/state_and_params.py:15-80). This framework keeps the same
architecture — a *separate process* that talks only to the stores — but
serves the view over HTTP with the standard library instead of an OpenGL
immediate-mode UI, so it works headless and from a remote browser:

  GET  /            HTML live view (scene image + stats, auto-refresh)
  GET  /state.json  live state: t, ego, planner/controller names +
                    runtimes, rule violations, controls
  GET  /scene.png   rendered scene (map, traffic, ego, planned traj)
  GET  /params.json planner/controller param bundles (live values)
  POST /select      {"planner": name} | {"controller": name}
  POST /param       {"target": "planning"|"control", "name": <component>,
                     "param": <key>, "value": <json value>}
  POST /sim         {"running": bool} | {"use_real_time": bool}

Param edits land in the same store attributes the apps read each tick
(planning_app.py registry: ``sh_planners.<name>.params``), so live tuning
behaves like the reference's param editor.
"""

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


_PAGE = """<!doctype html>
<html><head><title>tpl-tpu</title>
<style>
 body { font-family: sans-serif; background: #111; color: #eee;
        display: flex; gap: 1.5em; padding: 1em; }
 img  { border: 1px solid #444; }
 td   { padding: 0 0.6em 0 0; }
 select, button { margin: 0.2em 0; }
</style></head>
<body>
<div><img id="scene" width="640" height="640"/>
 <div><button onclick="toggleBirdseye()">birdseye</button></div>
 <img id="birdseye" width="640" height="640" style="display:none"/></div>
<div>
 <h3>tpl-tpu live</h3>
 <table id="stats"></table>
 <p>planner <select id="planner"></select>
    controller <select id="controller"></select></p>
 <p>param sets:
    planning <select id="ps_planning"></select>
    control <select id="ps_control"></select>
    <button onclick="loadPs()">load</button>
    <button onclick="savePs()">save</button></p>
 <p><button onclick="setSim(true)">run</button>
    <button onclick="setSim(false)">pause</button>
    <a href="editor" style="color:#4a9">map editor</a></p>
 <pre id="viol"></pre>
 <h4>events</h4>
 <pre id="events"></pre>
</div>
<script>
async function tick() {
  const s = await (await fetch('state.json')).json();
  const rows = [
    ['t', s.t.toFixed(2) + ' s'],
    ['ego v', s.ego.v.toFixed(2) + ' m/s'],
    ['planner', s.planning.active + ' (' +
      (1e3 * s.planning.runtime).toFixed(1) + ' ms)'],
    ['controller', s.control.active + ' (' +
      (1e3 * s.control.runtime).toFixed(1) + ' ms)'],
    ['controls', s.control.controls.map(x => x.toFixed(2)).join(', ')],
    ['violations', s.violations.length],
  ];
  document.getElementById('stats').innerHTML =
    rows.map(r => '<tr><td>' + r[0] + '</td><td>' + r[1] +
                  '</td></tr>').join('');
  document.getElementById('viol').textContent =
    s.violations.slice(0, 8).join('\\n');
  for (const [id, names, active] of [
      ['planner', s.planning.names, s.planning.active],
      ['controller', s.control.names, s.control.active]]) {
    const sel = document.getElementById(id);
    if (sel.length != names.length) {
      sel.innerHTML = names.map(n => '<option>' + n + '</option>').join('');
      sel.onchange = () => fetch('select', {method: 'POST',
        body: JSON.stringify({[id]: sel.value})});
    }
    if (document.activeElement !== sel) sel.value = active;
  }
  document.getElementById('scene').src = 'scene.png?' + Date.now();
  const be = document.getElementById('birdseye');
  if (be.style.display !== 'none')
    be.src = 'birdseye.png?' + Date.now();
  const ev = await (await fetch('events.json')).json();
  document.getElementById('events').textContent = ev.slice(0, 10)
    .map(e => e.t.toFixed(1) + '  ' + e.msg).join('\\n');
}
function setSim(running) {
  fetch('sim', {method: 'POST', body: JSON.stringify({running})});
}
function toggleBirdseye() {
  const be = document.getElementById('birdseye');
  be.style.display = be.style.display === 'none' ? '' : 'none';
}
async function refreshPs() {
  const ps = await (await fetch('paramsets.json')).json();
  for (const k of ['planning', 'control']) {
    const sel = document.getElementById('ps_' + k);
    sel.innerHTML = ps[k].names.map(n => '<option>' + n +
                                    '</option>').join('');
    sel.value = ps[k].active;
  }
}
function loadPs() {
  for (const k of ['planning', 'control'])
    fetch('paramset', {method: 'POST', body: JSON.stringify(
      {target: k, name: document.getElementById('ps_' + k).value})});
}
function savePs() {
  for (const k of ['planning', 'control'])
    fetch('paramset/save', {method: 'POST', body: JSON.stringify(
      {target: k, name: document.getElementById('ps_' + k).value})});
}
setInterval(tick, 500); tick(); refreshPs();
</script>
</body></html>
"""


_EDITOR_PAGE = """<!doctype html>
<html><head><title>tpl-tpu map editor</title>
<style>
 body { font-family: sans-serif; background: #111; color: #eee;
        display: flex; gap: 1.5em; padding: 1em; }
 canvas { border: 1px solid #444; background: #181818; }
 td { padding: 0 0.5em 0 0; }
 input { width: 5em; }
</style></head>
<body>
<canvas id="cv" width="820" height="820"></canvas>
<div>
 <h3>map editor</h3>
 <p>map <select id="map"></select>
    <button onclick="save()">save store</button>
    <button onclick="edit({op:'undo'})">undo (ctrl-z)</button></p>
 <p>mode <select id="mode">
    <option value="cp">control points</option>
    <option value="boundary">boundaries</option>
    <option value="item">items</option></select></p>
 <table>
  <tr><td>selected cp</td><td id="selidx">-</td></tr>
  <tr><td>d_left</td><td><input id="d_left" onchange="setF('d_left')"></td></tr>
  <tr><td>d_right</td><td><input id="d_right" onchange="setF('d_right')"></td></tr>
  <tr><td>v</td><td><input id="v" onchange="setF('v')"></td></tr>
 </table>
 <p><button onclick="insertCp()">insert after</button>
    <button onclick="deleteCp()">delete</button></p>
 <p>add <select id="itemkind">
    <option>velocity_limit</option><option>traffic_light</option>
    <option>cross_walk</option><option>turn_ind_point</option>
    <option>map_switch_point</option><option>intersection_path</option>
  </select>
  <button onclick="addItem()">item at last click</button>
  <button onclick="deleteItem()">delete item</button></p>
 <table id="itemfields"></table>
 <p style="max-width:22em;color:#999">cp mode: click selects, drag
    moves a control point · boundary mode: drag a road edge to reshape
    the width · item mode: click selects, drag moves an item · every
    edit re-discretizes the live map and invalidates planner warm
    starts</p>
 <pre id="err"></pre>
</div>
<script>
let M = null, sel = -1, selItem = -1, dragKind = null, side = null,
    view = null, lastClick = null;
const cv = document.getElementById('cv'), ctx = cv.getContext('2d');
const mode = () => document.getElementById('mode').value;
function fit() {
  const xs = M.control_points.map(p => p[0]),
        ys = M.control_points.map(p => p[1]);
  const x0 = Math.min(...xs), x1 = Math.max(...xs),
        y0 = Math.min(...ys), y1 = Math.max(...ys);
  const s = 0.92 * Math.min(cv.width / Math.max(1, x1 - x0),
                            cv.height / Math.max(1, y1 - y0));
  view = {s, ox: (x0 + x1) / 2, oy: (y0 + y1) / 2};
}
const W = p => [cv.width / 2 + (p[0] - view.ox) * view.s,
                cv.height / 2 - (p[1] - view.oy) * view.s];
const U = (px, py) => [view.ox + (px - cv.width / 2) / view.s,
                       view.oy - (py - cv.height / 2) / view.s];
function draw() {
  if (!M) return;
  ctx.clearRect(0, 0, cv.width, cv.height);
  for (const [b, c] of [[M.boundary_left, '#666'],
                        [M.boundary_right, '#666'],
                        [M.path, '#4a9']]) {
    if (!b.length) continue;
    ctx.strokeStyle = c; ctx.beginPath();
    b.forEach((p, i) => { const q = W(p);
      i ? ctx.lineTo(q[0], q[1]) : ctx.moveTo(q[0], q[1]); });
    ctx.stroke();
  }
  M.control_points.forEach((p, i) => {
    const q = W(p);
    ctx.fillStyle = i === sel ? '#fa0' : '#ccc';
    ctx.beginPath(); ctx.arc(q[0], q[1], i === sel ? 6 : 3.5, 0, 7);
    ctx.fill();
  });
  M.items.forEach((it, i) => {
    const q = W(it.pos);
    ctx.fillStyle = {traffic_light: '#e33', cross_walk: '#39e',
                     velocity_limit: '#ee3'}[it.kind] || '#c6c';
    const r = i === selItem ? 6 : 4;
    ctx.fillRect(q[0] - r, q[1] - r, 2 * r, 2 * r);
    ctx.fillStyle = '#999';
    ctx.fillText(it.kind, q[0] + 6, q[1] + 3);
  });
}
async function loadMap(key) {
  const prevUuid = selItem >= 0 && M ? M.items[selItem].uuid : null;
  M = await (await fetch('map.json?map=' + key)).json();
  if (M.error) { document.getElementById('err').textContent = M.error;
                 return; }
  if (!view) fit();
  sel = Math.min(sel, M.control_points.length - 1);
  selItem = prevUuid === null ? -1
      : M.items.findIndex(it => it.uuid === prevUuid);
  draw(); syncFields(); syncItemFields();
}
function syncFields() {
  document.getElementById('selidx').textContent = sel < 0 ? '-' : sel;
  for (const f of ['d_left', 'd_right', 'v']) {
    const col = {d_left: 2, d_right: 3, v: 4}[f];
    document.getElementById(f).value =
      sel < 0 ? '' : M.control_points[sel][col].toFixed(2);
  }
}
function syncItemFields() {
  const tbl = document.getElementById('itemfields');
  if (selItem < 0 || !M.items[selItem]) { tbl.innerHTML = ''; return; }
  const it = M.items[selItem];
  tbl.innerHTML = Object.entries(it)
    .filter(([k, v]) => typeof v === 'number' && k !== 'uuid')
    .map(([k, v]) => '<tr><td>' + k + '</td><td><input value="' +
         v + '" onchange="setItemF(\\'' + k + '\\', this.value)">' +
         '</td></tr>').join('');
}
function setItemF(f, v) {
  if (selItem < 0) return;
  edit({op: 'set_item_field', uuid: M.items[selItem].uuid,
        field: f, value: parseFloat(v)});
}
async function edit(req) {
  req.map = document.getElementById('map').value;
  const r = await fetch('map/edit', {method: 'POST',
    body: JSON.stringify(req)});
  const e = await r.json();
  document.getElementById('err').textContent = e.error || '';
  await loadMap(req.map);
}
function setF(f) {
  if (sel < 0) return;
  edit({op: 'set_cp_field', field: f, start: sel, end: sel,
        value: parseFloat(document.getElementById(f).value)});
}
function insertCp() {
  if (sel < 0 || !M) return;
  const p = M.control_points[sel],
        p2 = M.control_points[Math.min(sel + 1, M.control_points.length - 1)];
  edit({op: 'insert_cp', index: sel,
        x: (p[0] + p2[0]) / 2 + (sel + 1 === M.control_points.length ? 5 : 0),
        y: (p[1] + p2[1]) / 2});
}
function deleteCp() { if (sel >= 0) { edit({op: 'delete_cp', index: sel});
                                      sel = -1; } }
function addItem() {
  if (!lastClick) return;
  edit({op: 'add_item', kind: document.getElementById('itemkind').value,
        x: lastClick[0], y: lastClick[1]});
}
function deleteItem() {
  if (selItem < 0) return;
  edit({op: 'delete_item', uuid: M.items[selItem].uuid});
  selItem = -1;
}
function nearest(pts, mx, my, maxD) {
  let best = -1, bd = maxD * maxD;
  pts.forEach((p, i) => {
    const q = W(p), d = (q[0] - mx) ** 2 + (q[1] - my) ** 2;
    if (d < bd) { bd = d; best = i; }
  });
  return best;
}
cv.onmousedown = ev => {
  if (!M) return;
  const r = cv.getBoundingClientRect(),
        mx = ev.clientX - r.left, my = ev.clientY - r.top;
  lastClick = U(mx, my);
  dragKind = null;
  if (mode() === 'cp') {
    sel = nearest(M.control_points, mx, my, 12);
    if (sel >= 0) dragKind = 'cp';
  } else if (mode() === 'item') {
    selItem = nearest(M.items.map(it => it.pos), mx, my, 14);
    if (selItem >= 0) dragKind = 'item';
  } else {
    const il = nearest(M.boundary_left, mx, my, 14),
          ir = nearest(M.boundary_right, mx, my, 14);
    if (il >= 0 || ir >= 0) {
      const dl = il >= 0 ? Math.hypot(W(M.boundary_left[il])[0] - mx,
                                      W(M.boundary_left[il])[1] - my) : 1e9,
            dr = ir >= 0 ? Math.hypot(W(M.boundary_right[ir])[0] - mx,
                                      W(M.boundary_right[ir])[1] - my) : 1e9;
      side = dl < dr ? 'left' : 'right';
      dragKind = 'boundary';
    }
  }
  syncFields(); syncItemFields(); draw();
};
cv.onmousemove = ev => {
  if (!dragKind) return;
  const r = cv.getBoundingClientRect(),
        u = U(ev.clientX - r.left, ev.clientY - r.top);
  if (dragKind === 'cp' && sel >= 0) {
    M.control_points[sel][0] = u[0]; M.control_points[sel][1] = u[1];
  } else if (dragKind === 'item' && selItem >= 0) {
    M.items[selItem].pos = u;
  } else if (dragKind === 'boundary') {
    lastClick = u;
  }
  draw();
};
cv.onmouseup = ev => {
  if (dragKind === 'cp' && sel >= 0)
    edit({op: 'move_cp', index: sel, x: M.control_points[sel][0],
          y: M.control_points[sel][1]});
  else if (dragKind === 'item' && selItem >= 0)
    edit({op: 'move_item', uuid: M.items[selItem].uuid,
          x: M.items[selItem].pos[0], y: M.items[selItem].pos[1]});
  else if (dragKind === 'boundary')
    edit({op: 'drag_boundary', side: side,
          x: lastClick[0], y: lastClick[1]});
  dragKind = null;
};
document.onkeydown = ev => {
  if (ev.ctrlKey && ev.key === 'z'
      && !['INPUT', 'SELECT', 'TEXTAREA'].includes(ev.target.tagName)) {
    ev.preventDefault();
    edit({op: 'undo'});
  }
};
async function save() {
  const r = await fetch('map/save', {method: 'POST', body: '{}'});
  const e = await r.json();
  document.getElementById('err').textContent =
    e.error || ('saved: ' + e.path);
}
(async () => {
  const maps = await (await fetch('maps.json')).json();
  const sel2 = document.getElementById('map');
  sel2.innerHTML = Object.keys(maps).map(
    k => '<option>' + k + '</option>').join('');
  sel2.onchange = () => { view = null; loadMap(sel2.value); };
  if (sel2.value) loadMap(sel2.value);
})();
</script>
</body></html>
"""


def _to_jsonable(v):
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, (list, tuple)):
        return [_to_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {k: _to_jsonable(x) for k, x in v.items()}
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    return str(v)


class GuiServer:
    """Serve a live view of (and control surface over) the app stores.

    Pass store objects directly for in-process use (tests, standalone
    sims), or let it attach by ``app_id`` over shared memory like the
    reference GUI process does.
    """

    def __init__(self, app_id="", host="127.0.0.1", port=8023,
                 env=None, sim_store=None, planning_store=None,
                 control_store=None):
        if env is None or sim_store is None:
            import os
            os.environ.setdefault("TPL_TPU_SHM", "1")
        from tpl_tpu import util

        if sim_store is None:
            # SimCore appends "_" to non-empty app ids (core.py:36-40)
            sim_id = app_id + "_" if app_id else app_id
            sim_store = util.StoreRegistry.get(f"/{sim_id}tpl_sim")
        if planning_store is None:
            planning_store = util.StoreRegistry.get(
                f"/{app_id}tpl_planning")
        if control_store is None:
            control_store = util.StoreRegistry.get(f"/{app_id}tpl_control")
        if env is None:
            from tpl_tpu.util.shm_store import ShmObject
            from tpl_tpu.environment import EnvironmentState
            env = ShmObject(EnvironmentState(), f"/{app_id}tpl_env")

        self.env = env
        self.sim_store = sim_store
        self.planning_store = planning_store
        self.control_store = control_store

        from tpl_tpu.gui.map_editor import MapEditor
        from tpl_tpu.gui.event_log import EventLog
        self.map_editor = MapEditor(env)
        self.event_log = EventLog(env, planning_store)

        gui = self

        class Handler(BaseHTTPRequestHandler):

            def log_message(self, *a):
                pass

            def _send(self, code, body, ctype="application/json"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path, _, query = self.path.partition("?")
                try:
                    if path == "/":
                        self._send(200, _PAGE.encode(), "text/html")
                    elif path == "/editor":
                        self._send(200, _EDITOR_PAGE.encode(), "text/html")
                    elif path == "/state.json":
                        self._send(200, json.dumps(
                            gui.state_dict()).encode())
                    elif path == "/params.json":
                        self._send(200, json.dumps(
                            gui.params_dict()).encode())
                    elif path == "/paramsets.json":
                        self._send(200, json.dumps(
                            gui.paramsets_dict()).encode())
                    elif path == "/maps.json":
                        self._send(200, json.dumps(
                            gui.map_editor.list_maps()).encode())
                    elif path == "/map.json":
                        from urllib.parse import parse_qs
                        key = parse_qs(query).get("map", [""])[0]
                        self._send(200, json.dumps(
                            gui.map_editor.map_dict(key)).encode())
                    elif path == "/events.json":
                        self._send(200, json.dumps(
                            gui.event_log.events()).encode())
                    elif path == "/scene.png":
                        self._send(200, gui.scene_png(), "image/png")
                    elif path == "/birdseye.png":
                        self._send(200, gui.birdseye_png(), "image/png")
                    else:
                        self._send(404, b"{}")
                except Exception as e:
                    self._send(500, json.dumps(
                        {"error": repr(e)}).encode())

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                try:
                    req = json.loads(self.rfile.read(length) or b"{}")
                    if self.path == "/select":
                        gui.select(req)
                    elif self.path == "/param":
                        gui.set_param(req["target"], req["name"],
                                      req["param"], req["value"])
                    elif self.path == "/sim":
                        gui.set_sim(req)
                    elif self.path == "/paramset":
                        gui.load_paramset(req["target"], req["name"])
                    elif self.path == "/paramset/save":
                        gui.save_paramset(req["target"],
                                          req.get("name"))
                    elif self.path == "/map/edit":
                        gui.map_editor.edit(req)
                    elif self.path == "/map/save":
                        out = gui.map_editor.save(req.get("store_path"))
                        self._send(200, json.dumps({"path": out}).encode())
                        return
                    else:
                        self._send(404, b"{}")
                        return
                    self._send(200, b"{}")
                except Exception as e:
                    self._send(400, json.dumps(
                        {"error": repr(e)}).encode())

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._thread = None

    # store access -------------------------------------------------

    def _snapshot_sim(self):
        self.sim_store.revalidate()
        with self.sim_store.lock():
            import copy
            return copy.deepcopy(self.sim_store.sim)

    def state_dict(self):
        sim = self._snapshot_sim()
        self.planning_store.revalidate()
        with self.planning_store.lock():
            planning = dict(
                active=self.planning_store.active_planner,
                names=list(self.planning_store.planner_names),
                runtime=float(self.planning_store.runtime))
        self.control_store.revalidate()
        with self.control_store.lock():
            control = dict(
                active=self.control_store.active_controller,
                names=list(self.control_store.controller_names),
                runtime=float(self.control_store.runtime),
                controls=[float(c) for c in self.control_store.controls])
        return _to_jsonable(dict(
            t=float(sim.t),
            running=bool(sim.settings.running),
            ego=dict(x=float(sim.ego.x), y=float(sim.ego.y),
                     v=float(sim.ego.v), yaw=float(sim.ego.yaw)),
            n_cars=len(sim.cars),
            planning=planning,
            control=control,
            violations=[str(v) for v in sim.rule_checker.violations]))

    def params_dict(self):
        from tpl_tpu.util import get_obj_dict
        out = {"planning": {}, "control": {}}
        for key, store in (("planning", self.planning_store),
                           ("control", self.control_store)):
            store.revalidate()
            with store.lock():
                names = list(getattr(
                    store, "planner_names" if key == "planning"
                    else "controller_names"))
                for n in names:
                    comp = getattr(store, n, None)
                    params = getattr(comp, "params", None)
                    if params is not None:
                        out[key][n] = _to_jsonable(get_obj_dict(params))
        return out

    def scene_png(self):
        from tpl_tpu.simulation.renderer import SceneRenderer
        import matplotlib.pyplot as plt
        if not hasattr(self, "_scene_renderer"):
            # stateful: keeps per-object history trails across requests
            self._scene_renderer = SceneRenderer()
        sim = self._snapshot_sim()
        self.env.revalidate()
        self.planning_store.revalidate()
        rgb = self._scene_renderer(self.env, sim,
                                   planners=self.planning_store)
        buf = io.BytesIO()
        plt.imsave(buf, rgb, format="png")
        return buf.getvalue()

    def birdseye_png(self):
        """Bird's-eye camera panel (reference slot:
        gui/components/carla_birdseye_component.py; see
        tpl_tpu/gui/birdseye.py for the source contract)."""
        from tpl_tpu.gui.birdseye import BirdseyeView
        if not hasattr(self, "_birdseye"):
            self._birdseye = BirdseyeView()
        sim = self._snapshot_sim()
        self.env.revalidate()
        return self._birdseye.png(self.env, sim)

    # mutations ----------------------------------------------------

    def select(self, req):
        if "planner" in req:
            with self.planning_store.lock():
                assert req["planner"] in self.planning_store.planner_names
                self.planning_store.active_planner = req["planner"]
        if "controller" in req:
            with self.control_store.lock():
                assert (req["controller"]
                        in self.control_store.controller_names)
                self.control_store.active_controller = req["controller"]

    def set_param(self, target, name, param, value):
        store = (self.planning_store if target == "planning"
                 else self.control_store)
        with store.lock():
            comp = getattr(store, name)
            params = comp.params
            if not hasattr(params, param):
                raise KeyError(f"{target}/{name} has no param {param!r}")
            setattr(params, param, value)
            # republish nested mutation through ShmStore (its attr dict
            # holds the bundle by reference in-process; over shm the
            # write-back on lock exit persists it)
            setattr(store, name, comp)

    # named param sets (reference: gui/state_and_params.py:15-29 param
    # set selector with live load/save)

    _KINDS = {"planning": ("active_planner", "planner_names"),
              "control": ("active_controller", "controller_names")}

    def _param_store(self, target):
        if target not in self._KINDS:
            raise KeyError(f"target must be planning/control: {target!r}")
        store = (self.planning_store if target == "planning"
                 else self.control_store)
        return store, *self._KINDS[target]

    def paramsets_dict(self):
        import os
        from tpl_tpu import util
        out = {}
        for target in self._KINDS:
            store, _, _ = self._param_store(target)
            store.revalidate()
            with store.lock():
                active = getattr(store, "storage", "default")
            names = set()
            bases = [os.path.join(util.PATH_PARAMS, target)]
            bases += [os.path.join(r, "params", target)
                      for r in util.data_roots()]
            for b in bases:
                if os.path.isdir(b):
                    names.update(
                        n for n in os.listdir(b)
                        if os.path.isfile(os.path.join(b, n, "state.json")))
            out[target] = dict(names=sorted(names), active=active)
        return out

    def load_paramset(self, target, name):
        from tpl_tpu.application.registry import merge_param_set
        store, active_key, names_key = self._param_store(target)
        store.revalidate()
        with store.lock():
            if not merge_param_set(store, target, active_key, name):
                raise KeyError(f"no param set {target}/{name!r}")
            # republish nested mutations through the store (shm writers
            # persist on attribute set, not on in-place edits)
            for n in list(getattr(store, names_key)):
                comp = getattr(store, n, None)
                if comp is not None:
                    setattr(store, n, comp)

    def save_paramset(self, target, name=None):
        from tpl_tpu.application.registry import save_param_set
        store, active_key, names_key = self._param_store(target)
        store.revalidate()
        with store.lock():
            if name:
                store.storage = name
            save_param_set(store, target, active_key,
                           list(getattr(store, names_key)))

    def set_sim(self, req):
        with self.sim_store.lock():
            sim = self.sim_store.sim
            if "running" in req:
                sim.settings.running = bool(req["running"])
            if "use_real_time" in req:
                sim.settings.use_real_time = bool(req["use_real_time"])
            if "save_scenario" in req:
                from tpl_tpu.simulation.state import save_sim_state
                save_sim_state(sim, req["save_scenario"])
            self.sim_store.sim = sim

    # lifecycle ----------------------------------------------------

    def start(self):
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def serve_forever(self):
        print(f"tplgui serving on http://{self.httpd.server_address[0]}"
              f":{self.port}/")
        self.httpd.serve_forever()


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(prog="tplgui")
    p.add_argument("--app-id", default="")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8023)
    args = p.parse_args(argv)
    GuiServer(app_id=args.app_id, host=args.host,
              port=args.port).serve_forever()


if __name__ == "__main__":
    main()
