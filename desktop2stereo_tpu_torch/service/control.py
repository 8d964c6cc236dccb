"""Web control panel: the reference GUI's job on a host without a desktop.

Port of `desktop2stereo_tpu/service/control.py`; its worker is the port's
CLI.  The reference ships a Flet desktop GUI that edits settings.yaml,
spawns the worker as a subprocess, stops it through a stop.request file
(Windows) or a process-group SIGINT with a kill escalation, and tees its
output into a rolling log (reference gui.py:1325-3699, 3478-3568).  A
server holding the card has no desktop, so the same controls are a small
stdlib HTTP panel:

  python -m desktop2stereo_tpu_torch.service.control --port 8700

  GET  /            settings form (model/resolution/mode/... dropdowns)
  POST /start       write settings.yaml, spawn the CLI worker subprocess
  POST /stop        graceful stop (stop.request file → SIGINT → SIGKILL)
  GET  /status      {"running": bool, "pid": int|null, "stats": {...}}
  GET  /logs        tail of the rolling worker log
  GET  /windows     window titles for the capture dropdown

The worker's log, stop file and settings paths are relative to the working
directory the panel runs in.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from desktop2stereo_tpu_torch.core.config import (DISPLAY_MODES, Settings, load_settings,
                                                  save_settings)
from desktop2stereo_tpu_torch.core.registry import MODEL_REGISTRY

LOG_PATH = "logs/worker.log"
STOP_FILE = "logs/stop.request"


class WorkerManager:
    """Spawn/stop the pipeline worker (reference gui.py:3210-3568)."""

    def __init__(self, settings_path: str = "settings.yaml"):
        self.settings_path = settings_path
        self.proc: Optional[subprocess.Popen] = None
        self.lock = threading.Lock()
        os.makedirs("logs", exist_ok=True)

    @property
    def running(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def start(self, settings: Settings, source: str, sink: str,
              extra_args: "list[str] | None" = None) -> int:
        with self.lock:
            if self.running:
                raise RuntimeError("worker already running")
            save_settings(settings, self.settings_path)
            if os.path.exists(STOP_FILE):
                os.remove(STOP_FILE)
            log = open(LOG_PATH, "ab", buffering=0)
            cmd = [
                sys.executable, "-u", "-X", "faulthandler",
                "-m", "desktop2stereo_tpu_torch.cli",
                "--settings", self.settings_path,
                "--source", source, "--sink", sink,
                "--stop-file", STOP_FILE,
            ] + (extra_args or [])
            self.proc = subprocess.Popen(
                cmd, stdout=log, stderr=subprocess.STDOUT,
                start_new_session=True,
            )
            return self.proc.pid

    def stop(self, grace_s: float = 8.0) -> bool:
        """stop.request file → SIGINT to the process group → SIGKILL
        (reference gui.py:3524-3568 escalation)."""
        with self.lock:
            if not self.running:
                return True
            proc = self.proc
        try:
            with open(STOP_FILE, "w") as f:
                f.write("stop")
        except OSError:
            pass
        deadline = time.monotonic() + grace_s / 2
        while time.monotonic() < deadline:
            if proc.poll() is not None:
                return True
            time.sleep(0.2)
        try:
            os.killpg(os.getpgid(proc.pid), signal.SIGINT)
        except (ProcessLookupError, PermissionError):
            pass
        deadline = time.monotonic() + grace_s / 2
        while time.monotonic() < deadline:
            if proc.poll() is not None:
                return True
            time.sleep(0.2)
        try:
            os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass
        return proc.poll() is not None


# Model-family / size parsing (the reference GUI's two-dropdown picker,
# reference gui.py:376-414 parse_model_name / build_family_size_map).
_MODEL_SIZES = ["Small", "SmallPlus", "Base", "Large", "Giant"]
_SIZE_ORDER = {s: i for i, s in enumerate(_MODEL_SIZES)}


def parse_model_name(name: str):
    """'Depth-Anything-V2-Small' → ('Depth-Anything-V2', 'Small'); trailing
    size tokens (possibly several, e.g. '...-Small-Plus') join the size."""
    parts = name.split("-")
    i = len(parts) - 1
    size_parts = []
    while i >= 0:
        matched = next((sz for sz in _MODEL_SIZES
                        if parts[i].upper() == sz.upper()), None)
        if not matched:
            break
        size_parts.insert(0, matched)
        i -= 1
    if size_parts:
        return "-".join(parts[: i + 1]), "-".join(size_parts)
    return name, ""


def build_family_size_map(model_names):
    """(families_ordered, {family: [sizes]}, {(family,size|''): full_name})"""
    families, fam_sizes, full = [], {}, {}
    for name in model_names:
        fam, size = parse_model_name(name)
        if fam not in fam_sizes:
            fam_sizes[fam] = []
            families.append(fam)
        if size and size not in fam_sizes[fam]:
            fam_sizes[fam].append(size)
        full[(fam, size)] = name
    for fam in fam_sizes:
        fam_sizes[fam].sort(key=lambda s: _SIZE_ORDER.get(s.split("-")[0], 99))
    return families, fam_sizes, full


def worker_stats_from_log(path: str = LOG_PATH) -> dict:
    """Live stats from the worker's rolling log: the last
    '[d2s] fps=12.3 (1%low=11.0) dropped=4 capture=...' status line
    (cli.py --stats-every output) parsed into numbers — the panel's
    equivalent of the reference GUI's live title-bar feed."""
    import re

    try:
        with open(path, "rb") as f:
            f.seek(0, 2)
            f.seek(max(0, f.tell() - 8192))
            tail = f.read().decode("utf-8", "replace")
    except OSError:
        return {}
    stats: dict = {}
    for line in reversed(tail.splitlines()):
        m = re.search(r"fps=([\d.]+) \(1%low=([\d.]+)\) dropped=(\d+)(.*)",
                      line)
        if m:
            stats = {"fps": float(m.group(1)), "fps_1pct_low": float(m.group(2)),
                     "dropped": int(m.group(3))}
            for k, v in re.findall(r"(\w[\w+-]*)=([\d.]+)ms", m.group(4)):
                stats.setdefault("latency_ms", {})[k] = float(v)
            break
    return stats


# Bilingual labels, the reference GUI's EN/中文 toggle (reference
# gui.py:570-604 keeps a translation dict and re-renders on switch).
_L10N = {
    "en": {
        "model": "Depth Model", "size": "Model Size",
        "depth_res": "Depth Resolution",
        "out_res": "Output Resolution", "mode": "Display Mode",
        "strength": "Depth Strength", "ipd": "IPD (m)",
        "convergence": "Convergence", "aa": "Anti-aliasing (0-5)",
        "fg": "Foreground Scale (0-10)", "smooth": "Temporal Smoothing",
        "fps": "Capture FPS", "device": "Computing Device",
        "monitor": "Input Monitor",
        "source": "Source", "window": "Input Window", "cursor": "Cursor",
        "sink": "Sink", "audio": "Audio (rtmp)", "quant": "Quantization",
        "port": "Port", "out": "Output Path", "input": "Input Path",
        "ingest": "Ingest Port (capture agent)",
        "refresh": "Refresh", "run": "Run", "stop": "Stop",
        "running": "running pid ",
        "stopped": "stopped", "lang_link": "中文",
    },
    "zh": {
        "model": "深度模型", "size": "模型规格",
        "depth_res": "深度分辨率",
        "out_res": "输出分辨率", "mode": "显示模式",
        "strength": "深度强度", "ipd": "瞳距 (米)",
        "convergence": "会聚", "aa": "抗锯齿 (0-5)",
        "fg": "前景缩放 (0-10)", "smooth": "时域平滑",
        "fps": "采集帧率", "device": "计算设备",
        "monitor": "输入显示器",
        "source": "输入源", "window": "输入窗口", "cursor": "光标",
        "sink": "输出", "audio": "音频 (rtmp)", "quant": "量化",
        "port": "端口", "out": "输出路径", "input": "输入路径",
        "ingest": "接收端口（采集代理）",
        "refresh": "刷新", "run": "运行", "stop": "停止",
        "running": "运行中 pid ",
        "stopped": "已停止", "lang_link": "English",
    },
}


def _enumerate_host() -> dict:
    """Host facts for the dropdowns: devices, monitors, windows (the
    reference GUI's get_devices/monitor/window enumeration,
    reference gui.py:376-470, 785-825)."""
    from desktop2stereo_tpu_torch.core.display import list_monitors
    from desktop2stereo_tpu_torch.sources.screen import list_windows

    devices = [("cuda", "CUDA"), ("cpu", "CPU")]
    monitors = [(i, f"{i}: {name} {w}x{h}+{x}+{y}")
                for i, (name, x, y, w, h) in enumerate(list_monitors())]
    return {"devices": devices, "monitors": monitors, "windows": list_windows()[:64]}


def _form_page(settings: Settings, lang: str = "en") -> bytes:
    import html as _html
    import json as _json

    families, fam_sizes, full_names = build_family_size_map(
        sorted(MODEL_REGISTRY))
    cur_fam, cur_size = parse_model_name(settings.model)
    fam_opts = "".join(
        f'<option {"selected" if f == cur_fam else ""}>{_html.escape(f)}</option>'
        for f in families)
    mode_opts = "".join(
        f'<option {"selected" if m == settings.display_mode else ""}>{m}</option>'
        for m in DISPLAY_MODES
    )
    host = _enumerate_host()
    mon_opts = '<option value="">auto</option>' + "".join(
        f'<option value="{i}">{_html.escape(label)}</option>'
        for i, label in host["monitors"])
    win_opts = "".join(
        f'<option value="{_html.escape(t, quote=True)}">'
        for t in host["windows"])
    dev_opts = "".join(f'<option value="{v}">{label}</option>'
                       for v, label in host["devices"])
    # per-model resolution menus (reference settings.yaml:5-314) for the
    # client-side dropdown swap when the model changes
    res_menus = _json.dumps({
        n: list(s.resolutions) for n, s in MODEL_REGISTRY.items()
        if s.resolutions
    })
    fam_map = _json.dumps(fam_sizes)
    name_map = _json.dumps({f"{f}|{s}": n
                            for (f, s), n in full_names.items()})
    # normalize BEFORE any interpolation: `lang` is user-controlled query
    # input and is echoed into HTML attributes below
    lang = "zh" if lang == "zh" else "en"
    L = _L10N[lang]
    other = "en" if lang == "zh" else "zh"
    smooth_sel = "checked" if settings.temporal_smooth else ""
    html = f"""<!doctype html><html><head><meta charset="utf-8">
<title>desktop2stereo control (torch)</title>
<style>body{{font-family:sans-serif;background:#111;color:#eee;max-width:640px;margin:2em auto}}
label{{display:block;margin:.6em 0 .2em}}select,input{{width:100%;padding:.3em;background:#222;color:#eee;border:1px solid #444;box-sizing:border-box}}
button{{margin-top:1em;padding:.5em 2em}}#log{{white-space:pre-wrap;font-family:monospace;font-size:11px;background:#000;padding:1em;max-height:280px;overflow:auto}}
#lang{{float:right;color:#8cf}}#stats{{font-family:monospace;color:#8f8}}
.row2{{display:flex;gap:.6em}}.row2>div{{flex:1}}
input[type=checkbox]{{width:auto}}</style>
</head><body>
<a id="lang" href="/?lang={other}">{L['lang_link']}</a>
<h2>desktop2stereo (torch)</h2>
<form method="post" action="/start?lang={lang}">
<div class="row2"><div>
<label>{L['model']}</label><select id="family" onchange="syncSizes()">{fam_opts}</select>
</div><div>
<label>{L['size']}</label><select id="msize" onchange="syncModel()"></select>
</div></div>
<input type="hidden" name="model" id="model" value="{_html.escape(settings.model, quote=True)}">
<div class="row2"><div>
<label>{L['depth_res']}</label><select name="depth_resolution" id="depth_resolution">
<option>{settings.depth_resolution}</option></select>
</div><div>
<label>{L['out_res']}</label><input name="output_resolution" value="{settings.output_resolution}">
</div></div>
<label>{L['mode']}</label><select name="display_mode">{mode_opts}</select>
<div class="row2"><div>
<label>{L['strength']}</label><input name="depth_strength" value="{settings.depth_strength}">
</div><div>
<label>{L['ipd']}</label><input name="ipd" value="{settings.ipd}">
</div><div>
<label>{L['convergence']}</label><input name="convergence" value="{settings.convergence}">
</div></div>
<div class="row2"><div>
<label>{L['aa']}</label><input name="anti_aliasing" value="{settings.anti_aliasing}">
</div><div>
<label>{L['fg']}</label><input name="foreground_scale_10" value="{settings.foreground_scale_10}">
</div><div>
<label>{L['fps']}</label><input name="fps" value="{settings.fps}">
</div></div>
<label><input type="checkbox" name="temporal_smooth" {smooth_sel}> {L['smooth']}</label>
<label>{L['device']}</label><select name="device">{dev_opts}</select>
<label>{L['source']}</label><select name="source" id="source" onchange="syncRows()"><option>screen</option><option>shm</option><option>synthetic</option><option>video</option><option>image</option><option>tcp</option></select>
<div id="row_monitor"><label>{L['monitor']}</label><select name="monitor">{mon_opts}</select></div>
<div id="row_window"><label>{L['window']} <a href="#" onclick="refreshWindows();return false">({L['refresh']})</a></label>
<input name="window_title" id="window_title" list="winlist" placeholder="(whole screen)">
<datalist id="winlist">{win_opts}</datalist></div>
<div id="row_cursor"><label>{L['cursor']}</label><select name="cursor"><option value="on">on</option><option value="off">off</option></select></div>
<div id="row_input"><label>{L['input']}</label><input name="input" placeholder="/path/to/file"></div>
<div id="row_ingest"><label>{L['ingest']}</label><input name="ingest_port" placeholder="7800"></div>
<label>{L['sink']}</label><select name="sink" id="sink" onchange="syncRows()"><option>mjpeg</option><option>window</option><option>png</option><option>video</option><option>null</option><option>rtmp</option><option>xr</option><option>xr,mjpeg</option></select>
<div id="row_port"><label>{L['port']}</label><input name="port" placeholder="(default)"></div>
<div id="row_out"><label>{L['out']}</label><input name="out" placeholder="out"></div>
<div id="row_audio"><label>{L['audio']}</label><select name="audio"><option>auto</option><option>none</option></select></div>
<label>{L['quant']}</label><select name="quant"><option value="none">none (bf16)</option><option value="int8">int8</option></select>
<button type="submit">{L['run']}</button>
</form>
<form method="post" action="/stop?lang={lang}"><button type="submit">{L['stop']}</button></form>
<p id="status"></p><p id="stats"></p><div id="log"></div>
<script>
const RES_MENUS = {res_menus};
const FAM_SIZES = {fam_map};
const FULL_NAMES = {name_map};
const RUNNING = {json.dumps(L['running'])}, STOPPED = {json.dumps(L['stopped'])};
const CUR_SIZE = {_json.dumps(cur_size)};
function syncSizes(){{
 const fam=document.getElementById('family').value;
 const sizes=FAM_SIZES[fam]||[];
 const sel=document.getElementById('msize');
 const cur=sel.value||CUR_SIZE;
 if(sizes.length){{
  sel.innerHTML=sizes.map(s=>`<option ${{s===cur?'selected':''}}>${{s}}</option>`).join('');
  sel.disabled=false;
  if(!sizes.includes(cur)) sel.value=sizes[0];
 }} else {{ sel.innerHTML='<option>-</option>'; sel.disabled=true; }}
 syncModel();
}}
function syncModel(){{
 const fam=document.getElementById('family').value;
 const sel=document.getElementById('msize');
 const size=sel.disabled?'':sel.value;
 const name=FULL_NAMES[fam+'|'+size]||FULL_NAMES[fam+'|']||fam;
 document.getElementById('model').value=name;
 syncRes();
}}
function syncRes(){{
 const model=document.getElementById('model').value;
 const sel=document.getElementById('depth_resolution');
 const menu=RES_MENUS[model];
 if(!menu) return;
 const cur=parseInt(sel.value);
 sel.innerHTML=menu.map(r=>`<option ${{r===cur?'selected':''}}>${{r}}</option>`).join('');
 if(!menu.includes(cur)){{
  // nearest menu entry to the old value, not a jump to max resolution
  const near=menu.reduce((a,b)=>Math.abs(b-cur)<Math.abs(a-cur)?b:a);
  sel.value=near;
 }}
}}
function show(id,on){{document.getElementById(id).style.display=on?'':'none'}}
function syncRows(){{
 // per-mode row visibility (the reference GUI hides irrelevant rows per
 // run mode, reference gui.py per-mode visibility logic)
 const src=document.getElementById('source').value;
 const sink=document.getElementById('sink').value;
 show('row_monitor', src==='screen');
 show('row_window', src==='screen');
 show('row_cursor', src==='screen');
 show('row_input', src==='video'||src==='image'||src==='shm');
 show('row_ingest', src==='tcp');
 show('row_audio', sink.includes('rtmp'));
 show('row_port', sink.includes('mjpeg')||sink.includes('xr')||sink.includes('rtmp'));
 show('row_out', sink.includes('png')||sink.includes('video'));
}}
async function refreshWindows(){{
 const names=await (await fetch('/windows')).json();
 document.getElementById('winlist').innerHTML=
   names.map(n=>`<option value="${{n.replace(/"/g,'&quot;')}}">`).join('');
}}
async function tick(){{
 const s=await (await fetch('/status')).json();
 document.getElementById('status').textContent=s.running?(RUNNING+s.pid):STOPPED;
 const w=s.stats||{{}};
 document.getElementById('stats').textContent=
   w.fps!==undefined?`fps ${{w.fps}}  1%low ${{w.fps_1pct_low}}  dropped ${{w.dropped}}`+
   (w.latency_ms?('  '+Object.entries(w.latency_ms).map(([k,v])=>`${{k}} ${{v}}ms`).join('  ')):''):'';
 document.getElementById('log').textContent=await (await fetch('/logs')).text();
 const el=document.getElementById('log'); el.scrollTop=el.scrollHeight;
}}
setInterval(tick, 2000); tick(); syncSizes(); syncRows();
</script></body></html>"""
    return html.encode()


def serve(port: int = 8700, settings_path: str = "settings.yaml",
          host: str = "127.0.0.1") -> ThreadingHTTPServer:
    manager = WorkerManager(settings_path)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, code: int, body: bytes, ctype: str = "text/html"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802
            parsed = urllib.parse.urlparse(self.path)
            if parsed.path in ("/", "/index.html"):
                settings = (
                    load_settings(settings_path)
                    if os.path.exists(settings_path) else Settings()
                )
                lang = urllib.parse.parse_qs(parsed.query).get(
                    "lang", ["en"])[0]
                self._send(200, _form_page(settings, lang))
            elif self.path == "/status":
                body = json.dumps({
                    "running": self.server.manager.running,
                    "pid": (self.server.manager.proc.pid
                            if self.server.manager.running else None),
                    "stats": (worker_stats_from_log()
                              if self.server.manager.running else {}),
                }).encode()
                self._send(200, body, "application/json")
            elif self.path == "/windows":
                from desktop2stereo_tpu_torch.sources.screen import list_windows

                self._send(200, json.dumps(list_windows()[:64]).encode(),
                           "application/json")
            elif self.path == "/logs":
                try:
                    with open(LOG_PATH, "rb") as f:
                        f.seek(0, 2)
                        size = f.tell()
                        f.seek(max(0, size - 8192))
                        body = f.read()
                except OSError:
                    body = b""
                self._send(200, body, "text/plain")
            else:
                self._send(404, b"not found")

        def do_POST(self):  # noqa: N802
            length = int(self.headers.get("Content-Length", 0))
            fields = urllib.parse.parse_qs(self.rfile.read(length).decode())
            parsed = urllib.parse.urlparse(self.path)
            # normalize: the decoded value is echoed into a Location header
            lang = urllib.parse.parse_qs(parsed.query).get("lang", ["en"])[0]
            lang = "zh" if lang == "zh" else "en"

            def val(name, default):
                return fields.get(name, [default])[0]

            if parsed.path == "/start":
                base = (
                    load_settings(settings_path)
                    if os.path.exists(settings_path) else Settings()
                )
                settings = base.replace(
                    model=val("model", base.model),
                    depth_resolution=int(val("depth_resolution", base.depth_resolution)),
                    output_resolution=int(val("output_resolution", base.output_resolution)),
                    display_mode=val("display_mode", base.display_mode),
                    depth_strength=float(val("depth_strength", base.depth_strength)),
                    ipd=float(val("ipd", base.ipd)),
                    convergence=float(val("convergence", base.convergence)),
                    anti_aliasing=float(val("anti_aliasing", base.anti_aliasing)),
                    foreground_scale_10=float(
                        val("foreground_scale_10", base.foreground_scale_10)),
                    fps=float(val("fps", base.fps)),
                    # unchecked checkboxes are absent from the form post
                    temporal_smooth="temporal_smooth" in fields,
                )
                extra = []
                if val("window_title", ""):
                    extra += ["--window-title", val("window_title", "")]
                if val("cursor", "on") == "off":
                    extra += ["--no-cursor"]
                if val("monitor", ""):
                    extra += ["--monitor", val("monitor", "")]
                if val("input", ""):
                    extra += ["--input", val("input", "")]
                if val("port", ""):
                    extra += ["--port", val("port", "")]
                if val("out", ""):
                    extra += ["--out", val("out", "")]
                if val("device", "cuda") != "cuda":
                    extra += ["--device", val("device", "cuda")]
                if val("audio", "auto") != "auto":
                    extra += ["--audio", val("audio", "auto")]
                if val("quant", "none") != "none":
                    extra += ["--quant", val("quant", "none")]
                source = val("source", "synthetic")
                if source == "tcp":
                    # remote capture agent feeds this port (sources/net.py)
                    source = "tcp:" + (val("ingest_port", "") or "7800")
                try:
                    self.server.manager.start(settings, source,
                                  val("sink", "mjpeg"), extra_args=extra)
                except RuntimeError as e:
                    self._send(409, str(e).encode())
                    return
            elif parsed.path == "/stop":
                self.server.manager.stop()
            else:
                self._send(404, b"not found")
                return
            self.send_response(303)
            self.send_header("Location", f"/?lang={lang}")
            self.end_headers()

    server = ThreadingHTTPServer((host, port), Handler)
    server.manager = manager  # for tests
    return server


def main() -> None:
    p = argparse.ArgumentParser(prog="d2s-control")
    p.add_argument("--port", type=int, default=8700)
    p.add_argument("--settings", default="settings.yaml")
    p.add_argument("--host", default="127.0.0.1",
                   help="bind address; the panel can start desktop capture, "
                        "so exposing it (e.g. 0.0.0.0) is an explicit opt-in")
    args = p.parse_args()
    server = serve(args.port, args.settings, host=args.host)
    print(f"[control] panel at http://{args.host}:{args.port}/")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.manager.stop()


if __name__ == "__main__":
    main()
