"""Static-HTML 2D-3D correspondence picker for the manual initial guess.

Port of `pointcloudprocessor_tpu/tools/pick_tool.py`: the same page, the
same embedded data, with the culled clouds projected by the port's camera
model on ``--device`` (default ``cuda``). The reference's `InitialGuessManual`
(`PointCloudProcessor/include/vlcal/initial_guess_manual.hpp:29-355`) is an
interactive Iridescence viewer: right-click picks a 3D point (:174-185) and
a 2D pixel via an OpenCV window (:297-330); >= 3 pairs feed RANSAC + LSQ.
No display exists on a headless host, so this tool closes the workflow gap
headlessly: it writes ONE self-contained HTML file (no network, no server)
that embeds each keyframe's image and its culled cloud projected into the
image (TURBO intensity colors, like `PointsColorUpdater`,
`points_color_updater.cpp:37-61`). Opened in any browser, it supports
zoom/pan, a blend slider (the `VisualLiDARVisualizer` slider,
`visual_lidar_visualizer.cpp:39-78`), click-to-pick alternating 3D point
(snaps to the nearest projected point, returning its CAMERA-FRAME
coordinates) and 2D pixel, and exports exactly the JSON schema consumed by
`pipeline/manual_guess.py`:

    {"<ts>": {"pixels": [[u, v], ...], "points": [[x, y, z], ...]}, ...}

Usage:
    python -m pointcloudprocessor_tpu_torch.tools.pick_tool \
        --filtered-pcd-dir out/filtered_pcd --images-folder images \
        --intrinsic FX FY CX CY --output picks.html --device cuda
    # open picks.html, pick >= 3 pairs per keyframe, Export JSON, then:
    python -m pointcloudprocessor_tpu_torch.cli ... \
        --enableInitialGuessManual --correspondences picks.json
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import sys

import numpy as np

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>pcp-tpu pick tool</title>
<style>
 body {{ font-family: sans-serif; margin: 0; display: flex; height: 100vh; }}
 #side {{ width: 320px; padding: 10px; overflow-y: auto; background: #f4f4f4;
          border-right: 1px solid #ccc; flex-shrink: 0; }}
 #main {{ flex: 1; overflow: hidden; position: relative; background: #222; }}
 canvas {{ display: block; cursor: crosshair; }}
 .pair {{ font: 12px monospace; margin: 2px 0; }}
 .pair button {{ font-size: 10px; margin-left: 4px; }}
 #status {{ font: 12px monospace; color: #333; white-space: pre-wrap; }}
 label {{ font-size: 12px; display: block; margin-top: 8px; }}
 select, button {{ margin-top: 4px; }}
</style></head><body>
<div id="side">
  <h3>2D&ndash;3D pick tool</h3>
  <label>Keyframe
    <select id="kf"></select>
  </label>
  <label>Point blend <input type="range" id="blend" min="0" max="100" value="65"></label>
  <label>Point size <input type="range" id="psize" min="1" max="6" value="2"></label>
  <label><input type="checkbox" id="showpts" checked> show points</label>
  <p id="status">Click = pick 3D point (snaps to nearest projected point).
Shift+Click = pick 2D pixel (exact).
Picks alternate 3D &rarr; 2D into pairs. Wheel = zoom, drag = pan.</p>
  <details id="posebox">
    <summary>Live pose preview</summary>
    <div id="posesliders"></div>
    <div id="posereadout" style="font: 11px monospace;"></div>
    <button id="posereset">Reset pose</button>
  </details>
  <div id="pairs"></div>
  <button id="undo">Undo last</button>
  <button id="clear">Clear keyframe</button>
  <hr>
  <button id="export">Export JSON</button>
  <textarea id="out" rows="8" style="width:100%; font: 10px monospace;"></textarea>
</div>
<div id="main"><canvas id="cv"></canvas></div>
<script>
const DATA = {data_json};
const kfSel = document.getElementById('kf');
Object.keys(DATA).forEach(ts => {{
  const o = document.createElement('option'); o.value = ts; o.textContent = ts;
  kfSel.appendChild(o);
}});
const cv = document.getElementById('cv'), ctx = cv.getContext('2d');
let img = new Image(), view = {{x: 0, y: 0, s: 1}}, pending3d = null;
const picks = {{}};  // ts -> [{{px:[u,v], pt:[x,y,z]}}]
Object.keys(DATA).forEach(ts => picks[ts] = []);

function cur() {{ return DATA[kfSel.value]; }}

// --- Live pose preview -----------------------------------------------------
// Headless stand-in for the reference's SE(3) gizmo + 50 ms recolor thread
// (`visual_lidar_visualizer.cpp:89-100`, `initial_guess_manual.hpp:170-215`):
// six sliders define a candidate correction T = (R(rvec), t) applied to the
// embedded CAMERA-FRAME points; the overlay reprojects live on every change.
// `liveProject` must match models/camera.py project_xyz EXACTLY — its Python
// twin `preview_project` below is asserted against the camera model in
// tests/test_pick_tool.py.
const POSE_AXES = [
  ['tx', -0.3, 0.3, 0.001, 'm'], ['ty', -0.3, 0.3, 0.001, 'm'],
  ['tz', -0.3, 0.3, 0.001, 'm'], ['rx', -3, 3, 0.01, 'deg'],
  ['ry', -3, 3, 0.01, 'deg'], ['rz', -3, 3, 0.01, 'deg']];
const pose = {{tx:0, ty:0, tz:0, rx:0, ry:0, rz:0}};
const psDiv = document.getElementById('posesliders');
POSE_AXES.forEach(([ax, lo, hi, st, unit]) => {{
  const l = document.createElement('label');
  l.textContent = `${{ax}} (${{unit}})`;
  const r = document.createElement('input');
  r.type = 'range'; r.min = lo; r.max = hi; r.step = st; r.value = 0;
  r.id = 'pose_' + ax;
  r.addEventListener('input', () => {{ pose[ax] = +r.value; poseChanged(); }});
  l.appendChild(r); psDiv.appendChild(l);
}});
function poseIdentity() {{
  return POSE_AXES.every(([ax]) => pose[ax] === 0);
}}
function rotFromVec(r) {{  // Rodrigues: rotation vector (rad) -> row-major 3x3
  const th = Math.hypot(r[0], r[1], r[2]);
  if (th < 1e-12) return [1,0,0, 0,1,0, 0,0,1];
  const kx = r[0]/th, ky = r[1]/th, kz = r[2]/th;
  const c = Math.cos(th), s = Math.sin(th), v = 1 - c;
  return [c + kx*kx*v, kx*ky*v - kz*s, kx*kz*v + ky*s,
          ky*kx*v + kz*s, c + ky*ky*v, ky*kz*v - kx*s,
          kz*kx*v - ky*s, kz*ky*v + kx*s, c + kz*kz*v];
}}
function liveProject(cm, R, t, x, y, z) {{  // == camera.py project_xyz
  const px = R[0]*x + R[1]*y + R[2]*z + t[0];
  const py = R[3]*x + R[4]*y + R[5]*z + t[1];
  const pz = R[6]*x + R[7]*y + R[8]*z + t[2];
  const sz = Math.abs(pz) < 1e-9 ? (pz < 0 ? -1e-9 : 1e-9) : pz;
  const xn = px/sz, yn = py/sz;
  const k1 = cm.d[0], k2 = cm.d[1], p1 = cm.d[2], p2 = cm.d[3], k3 = cm.d[4];
  const x2 = xn*xn, y2 = yn*yn, xy = xn*yn;
  const r2 = x2 + y2, r4 = r2*r2, r6 = r2*r4;
  const rc = 1 + k1*r2 + k2*r4 + k3*r6;
  const xd = rc*xn + p1*(2*xy) + p2*(r2 + 2*x2);
  const yd = rc*yn + p1*(r2 + 2*y2) + p2*(2*xy);
  return [cm.fx*xd + cm.cx, cm.fy*yd + cm.cy, pz];
}}
function poseChanged() {{
  const d = cur();
  if (poseIdentity()) {{ delete d.lu; delete d.lv; delete d.lok; }}
  else {{
    const deg = Math.PI / 180.0;
    const R = rotFromVec([pose.rx*deg, pose.ry*deg, pose.rz*deg]);
    const t = [pose.tx, pose.ty, pose.tz];
    d.lu = new Float64Array(d.x.length); d.lv = new Float64Array(d.x.length);
    d.lok = new Uint8Array(d.x.length);
    for (let i = 0; i < d.x.length; i++) {{
      const uvz = liveProject(d.cam, R, t, d.x[i], d.y[i], d.z[i]);
      d.lu[i] = uvz[0]; d.lv[i] = uvz[1]; d.lok[i] = uvz[2] > 0 ? 1 : 0;
    }}
  }}
  document.getElementById('posereadout').textContent =
    `t=(${{pose.tx.toFixed(3)}}, ${{pose.ty.toFixed(3)}}, ${{pose.tz.toFixed(3)}}) m  ` +
    `r=(${{pose.rx.toFixed(2)}}, ${{pose.ry.toFixed(2)}}, ${{pose.rz.toFixed(2)}}) deg`;
  draw();
}}
document.getElementById('posereset').onclick = () => {{
  POSE_AXES.forEach(([ax]) => {{
    pose[ax] = 0; document.getElementById('pose_' + ax).value = 0;
  }});
  poseChanged();
}};
function dispU(d, i) {{ return d.lu ? d.lu[i] : d.u[i]; }}
function dispV(d, i) {{ return d.lv ? d.lv[i] : d.v[i]; }}
function dispOk(d, i) {{ return d.lok ? d.lok[i] === 1 : true; }}
function resize() {{
  const m = document.getElementById('main');
  cv.width = m.clientWidth; cv.height = m.clientHeight; draw();
}}
window.addEventListener('resize', resize);

function turbo(t) {{  // compact TURBO approximation
  const r = Math.round(255*Math.min(1, Math.max(0, 1.61 - Math.abs(4*t - 2.92))));
  const g = Math.round(255*Math.min(1, Math.max(0, 1.49 - Math.abs(4*t - 1.95))));
  const b = Math.round(255*Math.min(1, Math.max(0, 1.52 - Math.abs(4*t - 0.91))));
  return `rgb(${{r}},${{g}},${{b}})`;
}}
function draw() {{
  ctx.setTransform(1,0,0,1,0,0);
  ctx.clearRect(0,0,cv.width,cv.height);
  ctx.setTransform(view.s,0,0,view.s,view.x,view.y);
  ctx.drawImage(img, 0, 0);
  const d = cur(), blend = document.getElementById('blend').value/100.0;
  const ps = +document.getElementById('psize').value / view.s;
  if (document.getElementById('showpts').checked) {{
    ctx.globalAlpha = blend;
    for (let i = 0; i < d.u.length; i++) {{
      if (!dispOk(d, i)) continue;
      ctx.fillStyle = turbo(d.i[i]);
      ctx.fillRect(dispU(d, i)-ps/2, dispV(d, i)-ps/2, ps, ps);
    }}
    ctx.globalAlpha = 1.0;
  }}
  const pp = picks[kfSel.value];
  ctx.font = `${{14/view.s}}px sans-serif`;
  pp.forEach((pr, idx) => {{
    if (pr.proj) {{ ctx.strokeStyle = '#0f0'; cross(pr.proj, ps*3); label(idx+1, pr.proj); }}
    if (pr.px) {{ ctx.strokeStyle = '#ff0'; cross(pr.px, ps*3); label(idx+1, pr.px); }}
    if (pr.proj && pr.px) {{
      ctx.strokeStyle = '#0ff'; ctx.beginPath();
      ctx.moveTo(pr.proj[0], pr.proj[1]); ctx.lineTo(pr.px[0], pr.px[1]); ctx.stroke();
    }}
  }});
  if (pending3d) {{ ctx.strokeStyle = '#f0f'; cross(pending3d.proj, ps*4); }}
  function cross(p, r) {{
    ctx.lineWidth = 1.5/view.s; ctx.beginPath();
    ctx.moveTo(p[0]-r, p[1]); ctx.lineTo(p[0]+r, p[1]);
    ctx.moveTo(p[0], p[1]-r); ctx.lineTo(p[0], p[1]+r); ctx.stroke();
  }}
  function label(n, p) {{ ctx.fillStyle = '#fff'; ctx.fillText(n, p[0]+4/view.s, p[1]-4/view.s); }}
}}
function toImage(e) {{
  const r = cv.getBoundingClientRect();
  return [(e.clientX - r.left - view.x)/view.s, (e.clientY - r.top - view.y)/view.s];
}}
let dragging = null;
cv.addEventListener('mousedown', e => dragging = {{x: e.clientX, y: e.clientY, moved: false}});
cv.addEventListener('mousemove', e => {{
  if (!dragging) return;
  const dx = e.clientX - dragging.x, dy = e.clientY - dragging.y;
  if (Math.abs(dx) + Math.abs(dy) > 3) dragging.moved = true;
  view.x += dx; view.y += dy; dragging.x = e.clientX; dragging.y = e.clientY; draw();
}});
cv.addEventListener('mouseup', e => {{
  const wasDrag = dragging && dragging.moved; dragging = null;
  if (wasDrag) return;
  const [u, v] = toImage(e);
  if (e.shiftKey) {{  // 2D pixel pick
    if (!pending3d) {{ setStatus('Pick the 3D point first (plain click).'); return; }}
    picks[kfSel.value].push({{proj: pending3d.proj, pt: pending3d.pt, px: [u, v]}});
    pending3d = null; renderPairs(); draw();
  }} else {{          // 3D point pick: snap to nearest DISPLAYED point
    const d = cur(); let best = -1, bd = 1e18;
    for (let i = 0; i < d.u.length; i++) {{
      if (!dispOk(d, i)) continue;
      const dd = (dispU(d, i)-u)**2 + (dispV(d, i)-v)**2;
      if (dd < bd) {{ bd = dd; best = i; }}
    }}
    if (best < 0 || Math.sqrt(bd) > 30/view.s) {{ setStatus('No projected point near click.'); return; }}
    pending3d = {{proj: [dispU(d, best), dispV(d, best)], pt: [d.x[best], d.y[best], d.z[best]]}};
    setStatus(`3D pick: (${{pending3d.pt.map(a=>a.toFixed(3)).join(', ')}})\\nNow Shift+Click the matching pixel.`);
    draw();
  }}
}});
cv.addEventListener('wheel', e => {{
  e.preventDefault();
  const f = e.deltaY < 0 ? 1.2 : 1/1.2, [u, v] = toImage(e);
  view.s *= f; view.x -= u*(f-1)*view.s/f; view.y -= v*(f-1)*view.s/f; draw();
}});
function setStatus(s) {{ document.getElementById('status').textContent = s; }}
function renderPairs() {{
  const div = document.getElementById('pairs'); div.innerHTML = '';
  picks[kfSel.value].forEach((pr, i) => {{
    const el = document.createElement('div'); el.className = 'pair';
    el.textContent = `#${{i+1}} px(${{pr.px[0].toFixed(1)}},${{pr.px[1].toFixed(1)}}) ` +
                     `pt(${{pr.pt.map(a=>a.toFixed(2)).join(',')}})`;
    const b = document.createElement('button'); b.textContent = 'x';
    b.onclick = () => {{ picks[kfSel.value].splice(i,1); renderPairs(); draw(); }};
    el.appendChild(b); div.appendChild(el);
  }});
}}
document.getElementById('undo').onclick = () => {{
  if (pending3d) pending3d = null; else picks[kfSel.value].pop();
  renderPairs(); draw();
}};
document.getElementById('clear').onclick = () => {{
  picks[kfSel.value] = []; pending3d = null; renderPairs(); draw();
}};
document.getElementById('export').onclick = () => {{
  const out = {{}};
  for (const ts in picks) {{
    if (picks[ts].length === 0) continue;
    out[ts] = {{pixels: picks[ts].map(p => p.px), points: picks[ts].map(p => p.pt)}};
  }}
  const s = JSON.stringify(out, null, 1);
  document.getElementById('out').value = s;
  const a = document.createElement('a');
  a.href = URL.createObjectURL(new Blob([s], {{type: 'application/json'}}));
  a.download = 'picks.json'; a.click();
}};
['blend','psize','showpts'].forEach(id =>
  document.getElementById(id).addEventListener('input', draw));
function loadKf() {{
  img = new Image();
  img.onload = () => {{ view = {{x: 0, y: 0, s: Math.min(cv.width/img.width, cv.height/img.height)}}; draw(); }};
  img.src = cur().image;
  pending3d = null; renderPairs(); poseChanged();
}}
kfSel.addEventListener('change', loadKf);
resize(); loadKf();
</script></body></html>
"""


def build_keyframe_entry(camera, cloud_path: str, image_path: str, max_points: int):
    """Project one culled cloud into its image; return the embed dict.

    Culled clouds (`filtered_pcd/<ts>_beforeNID.pcd`) are already in the
    keyframe CAMERA frame (the frame `manual_guess.py` expects picked points
    in), so projection is the bare camera model, on the camera's device.
    """
    import torch

    from ..io import pcd
    from ..models import camera as cam

    data = pcd.read(cloud_path)
    pts = np.asarray(data.points, np.float32)
    inten = (
        np.asarray(data.intensity, np.float32)
        if data.intensity is not None
        else np.zeros(len(pts), np.float32)
    )
    lo, hi = float(inten.min()), float(inten.max())
    inten = (inten - lo) / max(hi - lo, 1e-12)

    uv = cam.project(camera, torch.as_tensor(pts, device=camera.intrinsic.device)).cpu().numpy()
    ok = (
        (pts[:, 2] > 0)
        & (uv[:, 0] >= 0) & (uv[:, 0] < camera.width)
        & (uv[:, 1] >= 0) & (uv[:, 1] < camera.height)
    )
    idx = np.flatnonzero(ok)
    if len(idx) > max_points:
        idx = idx[np.linspace(0, len(idx) - 1, max_points).astype(np.int64)]

    with open(image_path, "rb") as f:
        b64 = base64.b64encode(f.read()).decode("ascii")
    ext = os.path.splitext(image_path)[1].lstrip(".").lower() or "jpeg"
    ext = {"jpg": "jpeg"}.get(ext, ext)
    r3 = lambda a: [round(float(x), 3) for x in a]
    intr = camera.intrinsic.cpu().numpy().astype(np.float64)
    return {
        "image": f"data:image/{ext};base64,{b64}",
        "u": r3(uv[idx, 0]),
        "v": r3(uv[idx, 1]),
        "x": r3(pts[idx, 0]),
        "y": r3(pts[idx, 1]),
        "z": r3(pts[idx, 2]),
        "i": [round(float(x), 3) for x in inten[idx]],
        # Intrinsics for the page's live-pose reprojection (`liveProject`).
        "cam": {
            "fx": float(intr[0]), "fy": float(intr[1]),
            "cx": float(intr[2]), "cy": float(intr[3]),
            "d": [float(x) for x in camera.distortion.cpu().numpy().astype(np.float64)],
        },
    }


def preview_project(points, pose6, intrinsic, distortion):
    """Python twin of the page's `liveProject` + `rotFromVec` JS (kept
    line-for-line parallel; see `_PAGE`): camera-frame points (N, 3) under a
    candidate correction ``pose6`` = [tx, ty, tz, rx, ry, rz] (meters,
    RADIANS rotation vector) -> (u (N,), v (N,), z_after (N,)).

    tests/test_torch_tools.py asserts this twin agrees with the port's
    `models/camera.project` on random distorted points, which is what ties
    the embedded JS formula to the engine's camera model.
    """
    pts = np.asarray(points, np.float64)
    t = np.asarray(pose6[:3], np.float64)
    r = np.asarray(pose6[3:], np.float64)
    th = float(np.hypot(np.hypot(r[0], r[1]), r[2]))
    if th < 1e-12:
        R = np.eye(3)
    else:
        kx, ky, kz = r / th
        c, s, vv = np.cos(th), np.sin(th), 1.0 - np.cos(th)
        R = np.array([
            [c + kx * kx * vv, kx * ky * vv - kz * s, kx * kz * vv + ky * s],
            [ky * kx * vv + kz * s, c + ky * ky * vv, ky * kz * vv - kx * s],
            [kz * kx * vv - ky * s, kz * ky * vv + kx * s, c + kz * kz * vv],
        ])
    p = pts @ R.T + t
    pz = p[:, 2]
    sz = np.where(np.abs(pz) < 1e-9, np.where(pz < 0, -1e-9, 1e-9), pz)
    xn, yn = p[:, 0] / sz, p[:, 1] / sz
    k1, k2, p1, p2, k3 = (float(d) for d in distortion)
    x2, y2, xy = xn * xn, yn * yn, xn * yn
    r2 = x2 + y2
    r4 = r2 * r2
    r6 = r2 * r4
    rc = 1.0 + k1 * r2 + k2 * r4 + k3 * r6
    xd = rc * xn + p1 * (2.0 * xy) + p2 * (r2 + 2.0 * x2)
    yd = rc * yn + p1 * (r2 + 2.0 * y2) + p2 * (2.0 * xy)
    fx, fy, cx, cy = (float(i) for i in intrinsic)
    return fx * xd + cx, fy * yd + cy, pz


def generate(
    filtered_pcd_dir: str,
    images_folder: str,
    intrinsic,
    distortion,
    output: str,
    max_points: int = 20000,
    width: int = 0,
    height: int = 0,
    device="cuda",
) -> list[str]:
    """Write the self-contained picker HTML; returns the keyframe ts list.
    The clouds are projected on ``device``."""
    from ..models import camera as cam

    entries = {}
    ts_list = []
    for name in sorted(os.listdir(filtered_pcd_dir)):
        if not name.endswith("_beforeNID.pcd"):
            continue
        ts = name[: -len("_beforeNID.pcd")]
        img_path = None
        for ext in (".jpg", ".jpeg", ".png"):
            p = os.path.join(images_folder, ts + ext)
            if os.path.exists(p):
                img_path = p
                break
        if img_path is None:
            print(f"# skipping {ts}: no image in {images_folder}", file=sys.stderr)
            continue
        if not (width and height):
            from ..io import images as img_io

            h, w = img_io.load_rgb(img_path).shape[:2]
        else:
            w, h = width, height
        camera = cam.create_camera("pinhole", intrinsic, distortion, w, h, device)
        entries[ts] = build_keyframe_entry(
            camera, os.path.join(filtered_pcd_dir, name), img_path, max_points
        )
        ts_list.append(ts)

    if not entries:
        raise FileNotFoundError(
            f"no <ts>_beforeNID.pcd with matching images under {filtered_pcd_dir}"
        )
    html = _PAGE.format(data_json=json.dumps(entries, separators=(",", ":")))
    with open(output, "w") as f:
        f.write(html)
    return ts_list


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="static-HTML 2D-3D pick tool")
    ap.add_argument("--filtered-pcd-dir", required=True,
                    help="pipeline output dir with <ts>_beforeNID.pcd files")
    ap.add_argument("--images-folder", required=True)
    ap.add_argument("--intrinsic", type=float, nargs=4, required=True,
                    metavar=("FX", "FY", "CX", "CY"))
    ap.add_argument("--distortion", type=float, nargs=5, default=[0, 0, 0, 0, 0])
    ap.add_argument("--width", type=int, default=0, help="override image width")
    ap.add_argument("--height", type=int, default=0)
    ap.add_argument("--max-points", type=int, default=20000,
                    help="max embedded projected points per keyframe")
    ap.add_argument("--output", required=True, help="output .html path")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)
    ts = generate(
        args.filtered_pcd_dir, args.images_folder, args.intrinsic,
        args.distortion, args.output, args.max_points, args.width, args.height, args.device,
    )
    print(f"{args.output}: {len(ts)} keyframes ({', '.join(ts)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
