"""Point-cloud and image rendering, label palettes and maps (port of
``u2mkd_tpu/utils/visualize.py``, Pillow and numpy only).

The reference's ``visualize_utils.py`` opens an open3d window and draws
with matplotlib; here a bird's-eye-view PNG, a projection overlay on a
camera image, a confusion matrix and a self-contained HTML viewer (orbit,
zoom, class toggles) take their place, with the reference's palettes and
cross-dataset label maps kept as data. The height colouring of
:func:`save_bev_png` uses ``np.ptp`` (``ndarray.ptp`` left numpy 2.0).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

NUSC_CLASS_COLORS = np.array(
    [
        [0, 0, 0], [112, 128, 144], [220, 20, 60], [255, 127, 80],
        [255, 158, 0], [233, 150, 70], [255, 61, 99], [0, 0, 230],
        [47, 79, 79], [255, 140, 0], [255, 99, 71], [0, 207, 191],
        [175, 0, 75], [75, 0, 75], [112, 180, 60], [222, 184, 135],
        [0, 175, 0],
    ],
    np.uint8,
)

# 22-class palette covering the cross-dataset (kitti/waymo-extended) label
# space (reference ``visualize_utils.py:IDX2COLOR_22``); rows 0..16 equal
# NUSC_CLASS_COLORS
IDX2COLOR_22 = np.array(
    list(NUSC_CLASS_COLORS) + [
        [255, 40, 200],   # bicyclist
        [150, 30, 90],    # motorcyclist
        [150, 255, 170],  # lane_marker
        [255, 0, 0],      # traffic_sign
        [255, 150, 150],  # curb
        [255, 240, 150],  # pole
    ],
    np.uint8,
)

# camera-view index colors (reference ``visualize_utils.py:VIEW_COLORS``)
VIEW_COLORS = np.array(
    [[255, 0, 0], [0, 255, 0], [0, 0, 255], [255, 255, 0], [255, 0, 255],
     [0, 255, 255]],
    np.uint8,
)

# cross-dataset label maps into the 22-class space above (reference
# ``visualize_utils.py:MapSemKITTI2NUSC`` / ``MapWaymo2NUSC``)
MAP_SEMKITTI_TO_NUSC = {
    0: 0, 1: 4, 2: 2, 3: 6, 4: 10, 5: 5, 6: 7, 7: 17, 8: 18, 9: 11, 10: 12,
    11: 13, 12: 12, 13: 15, 14: 1, 15: 16, 16: 16, 17: 14, 18: 22, 19: 20,
}
MAP_WAYMO_TO_NUSC = {
    0: 0, 1: 4, 2: 10, 3: 3, 4: 5, 5: 18, 6: 17, 7: 7, 8: 8, 9: 20, 10: 22,
    11: 1, 12: 2, 13: 6, 14: 15, 15: 16, 16: 9, 17: 21, 18: 11, 19: 19,
    20: 12, 21: 14, 22: 13,
}


def save_bev_png(path: str, xyz: np.ndarray, labels: Optional[np.ndarray] = None,
                 extent: float = 50.0, size: int = 800):
    """Rasterize a bird's-eye-view of the cloud to a PNG (PIL only)."""
    from PIL import Image

    img = np.zeros((size, size, 3), np.uint8)
    u = ((xyz[:, 0] + extent) / (2 * extent) * (size - 1)).astype(int)
    v = ((xyz[:, 1] + extent) / (2 * extent) * (size - 1)).astype(int)
    ok = (u >= 0) & (u < size) & (v >= 0) & (v < size)
    if labels is not None:
        colors = NUSC_CLASS_COLORS[np.clip(labels, 0, len(NUSC_CLASS_COLORS) - 1)]
    else:
        z = xyz[:, 2]
        zn = np.clip((z - z.min()) / max(np.ptp(z), 1e-6), 0, 1)
        colors = np.stack([(zn * 255)] * 3, -1).astype(np.uint8)
    img[size - 1 - v[ok], u[ok]] = colors[ok]
    Image.fromarray(img).save(path)


def save_projection_overlay(path: str, image: np.ndarray, uv_norm: np.ndarray,
                            mask: np.ndarray, labels: Optional[np.ndarray] = None):
    """Draw projected points over a camera image (uv in [-1,1])."""
    from PIL import Image

    img = np.ascontiguousarray(image.astype(np.uint8))
    h, w = img.shape[:2]
    u = ((uv_norm[:, 0] + 1) / 2 * (w - 1)).astype(int)
    v = ((uv_norm[:, 1] + 1) / 2 * (h - 1)).astype(int)
    ok = mask & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    if labels is not None:
        colors = NUSC_CLASS_COLORS[np.clip(labels, 0, len(NUSC_CLASS_COLORS) - 1)]
    else:
        colors = np.full((len(u), 3), [255, 0, 0], np.uint8)
    img[v[ok], u[ok]] = colors[ok]
    Image.fromarray(img).save(path)


def confusion_matrix(pred: np.ndarray, target: np.ndarray, num_classes: int,
                     ignore_label: int = 0) -> np.ndarray:
    keep = target != ignore_label
    idx = target[keep] * num_classes + pred[keep]
    return np.bincount(idx, minlength=num_classes ** 2).reshape(
        num_classes, num_classes
    )


def export_html_viewer(path: str, xyz: np.ndarray,
                       labels: Optional[np.ndarray] = None,
                       class_names: Optional[list] = None,
                       max_points: int = 200000,
                       title: str = "point cloud",
                       predict: Optional[np.ndarray] = None,
                       view: Optional[np.ndarray] = None,
                       rgb: Optional[np.ndarray] = None,
                       select_inds: Optional[np.ndarray] = None) -> str:
    """Interactive point-cloud viewer as ONE self-contained HTML file.

    Replacement for the reference's open3d window (``visualize_pcd``,
    ``visualize_utils.py:226-328``) that works in a headless environment:
    drag = orbit, wheel = zoom, keys 0-9 toggle classes — open the file in
    any browser, no dependencies or network.

    Key-switchable colorings mirror the reference's key callbacks
    (``visualize_utils.py:312-317``):

      Q  ground-truth ``labels`` (IDX2COLOR_22 palette)
      W  ``predict`` labels (same palette)
      V  ``view`` camera index (VIEW_COLORS; -1 -> white)
      R  ``rgb`` per-point [N, 3] uint8 colors
      S  ``select_inds`` highlight (selected red over grey)

    Only colorings passed as arrays appear; the first available is the
    initial one.
    """
    import json as _json

    xyz = np.asarray(xyz, np.float32)
    n = len(xyz)
    if n > max_points:
        sel = np.random.RandomState(0).choice(n, max_points, replace=False)
    else:
        sel = slice(None)
    xyz = xyz[sel]
    xyz = xyz - xyz.mean(0)

    pal22 = IDX2COLOR_22.astype(int)
    modes = {}  # key -> {"name", "colors" [n,3] int}
    if labels is not None:
        lab = np.asarray(labels, np.int32)[sel]
        modes["q"] = {"name": "target",
                      "col": pal22[lab % len(pal22)].tolist(), "lab": lab}
    if predict is not None:
        pr = np.asarray(predict, np.int32)[sel]
        modes["w"] = {"name": "predict",
                      "col": pal22[pr % len(pal22)].tolist(), "lab": pr}
    if view is not None:
        vw = np.asarray(view, np.int32)[sel]
        vc = np.where((vw >= 0)[:, None],
                      VIEW_COLORS[np.clip(vw, 0, len(VIEW_COLORS) - 1)],
                      np.uint8(255))
        modes["v"] = {"name": "view", "col": vc.tolist(), "lab": vw}
    if rgb is not None:
        modes["r"] = {"name": "rgb",
                      "col": np.asarray(rgb, np.uint8)[sel].tolist()}
    if select_inds is not None:
        s_col = np.full((len(xyz), 3), 128, np.uint8)
        si = np.asarray(select_inds)
        if si.dtype == bool:
            si = si[sel]
            s_col[si] = (255, 0, 0)
        else:  # index array: map through the subsample selection
            m = np.zeros(n, bool)
            m[si] = True
            s_col[m[sel]] = (255, 0, 0)
        modes["s"] = {"name": "select", "col": s_col.tolist()}
    if not modes:
        lab = np.zeros(len(xyz), np.int32)
        modes["q"] = {"name": "height",
                      "col": pal22[lab].tolist(), "lab": lab}

    first = next(iter(modes))
    lab_maxes = [int(np.max(m["lab"])) for m in modes.values()
                 if "lab" in m and len(m["lab"])]
    k = max(lab_maxes) + 1 if lab_maxes else 1
    payload = {
        "pts": np.round(xyz, 3).tolist(),
        "modes": {key: {"name": m["name"], "col": m["col"],
                        "lab": m.get("lab", np.zeros(len(xyz), np.int32))
                        .tolist()} for key, m in modes.items()},
        "first": first,
        "names": list(class_names) if class_names else
                 [f"class {i}" for i in range(k)],
    }
    html = """<!DOCTYPE html><html><head><meta charset="utf-8">
<title>%TITLE%</title><style>
body{margin:0;background:#111;color:#ccc;font:12px monospace;overflow:hidden}
#hud{position:fixed;top:8px;left:8px;z-index:2;white-space:pre}
canvas{display:block}</style></head><body>
<div id="hud"></div>
<canvas id="c"></canvas><script>
const D=%DATA%;
const cv=document.getElementById('c'),ctx=cv.getContext('2d');
const hud=document.getElementById('hud');
let W,H;function rs(){W=cv.width=innerWidth;H=cv.height=innerHeight;}
rs();addEventListener('resize',()=>{rs();draw();});
let ry=0.7,rx=-1.0,zoom=9,hidden=new Set(),mode=D.first;
function draw(){
 const keys=Object.keys(D.modes).map(k=>k.toUpperCase()+':'+D.modes[k].name)
  .join(' ');
 hud.textContent='%TITLE% — drag: orbit, wheel: zoom, 0-9: toggle class, '+
  keys+'  [mode: '+D.modes[mode].name+']';
 ctx.fillStyle='#111';ctx.fillRect(0,0,W,H);
 const cy=Math.cos(ry),sy=Math.sin(ry),cx=Math.cos(rx),sx=Math.sin(rx);
 const s=Math.min(W,H)/zoom;
 const pts=D.pts,M=D.modes[mode],col=M.col,lab=M.lab;
 for(let i=0;i<pts.length;i++){
  if(hidden.has(lab[i]))continue;
  const p=pts[i];
  const x1=p[0]*cy-p[1]*sy, y1=p[0]*sy+p[1]*cy;
  const z2=y1*sx+p[2]*cx;
  const px=W/2+x1*s, py=H/2-z2*s;
  if(px<0||px>W||py<0||py>H)continue;
  const c=col[i];
  ctx.fillStyle=`rgb(${c[0]},${c[1]},${c[2]})`;
  ctx.fillRect(px,py,1.6,1.6);
 }
 ctx.fillStyle='#ccc';let y=40;
 for(let l=0;l<D.names.length;l++){
  ctx.fillStyle=hidden.has(l)?'#444':'#ccc';
  ctx.fillText(`${l}: ${D.names[l]}`,8,y);y+=14;}
}
let drag=false,lx=0,ly=0;
cv.onmousedown=e=>{drag=true;lx=e.clientX;ly=e.clientY;};
onmouseup=()=>drag=false;
onmousemove=e=>{if(!drag)return;ry+=(e.clientX-lx)*0.01;rx+=(e.clientY-ly)*0.01;
 lx=e.clientX;ly=e.clientY;draw();};
onwheel=e=>{zoom*=e.deltaY>0?1.1:0.9;draw();};
onkeydown=e=>{const k=e.key.toLowerCase();
 if(D.modes[k]){mode=k;draw();return;}
 const l=parseInt(e.key);if(!isNaN(l)){
 hidden.has(l)?hidden.delete(l):hidden.add(l);draw();}};
draw();</script></body></html>"""
    html = html.replace("%TITLE%", title).replace("%DATA%", _json.dumps(payload))
    with open(path, "w") as f:
        f.write(html)
    return path
