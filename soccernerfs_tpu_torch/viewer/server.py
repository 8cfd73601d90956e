"""snt-viewer: the interactive render server (counterpart of
soccernerfs_tpu/viewer/server.py, the same routes and page).

A stdlib threaded HTTP server with an embedded client over a trained
snapshot:

  GET  /              the viewer page (pointer-drag orbit, fov and time
                      sliders, output selector, keyframe panel, path
                      preview, render-path job control)
  GET  /scene         scene metadata (num cameras, has_time, aabb)
  GET  /scene_cameras training-camera frustums with thumbnails
  GET  /keyframes     current keyframe list
  POST /render        {"c2w": [[..]x3], "fov": deg, "width", "height",
                      "time"?, "output"?: rgb|depth|accumulation} -> PNG
  POST /keyframe      {"c2w", "fov", "time"?} -> appended count
  POST /update_keyframe, /remove_keyframe {"index"}, /clear_keyframes
  POST /path_cameras  {"steps_per_transition"?} -> interpolated frames
                      [{"c2w", "fov", "time"?}] for the client's preview
  POST /export_path   {"width", "height", "steps_per_transition", "fps"}
                      -> writes camera_path.json beside the run's config
                      and returns it (``scripts.render --traj filename``
                      reads it)
  POST /render_path   {"width", "height", "fps", "output"?} -> renders the
                      keyframe path in the background to
                      renders/viewer_path.mp4 (PNG frames without imageio)
  GET  /render_status, /render_preview; POST /cancel_render
  GET|POST /scene_tree, GET /logs, POST /export_commands

The client asks for a low resolution while the camera moves and the full
one at rest.  Renders share one lock: the server answers requests on many
threads, and the card renders one image at a time.

    python -m soccernerfs_tpu_torch.viewer.server --load-config <run>/config.yml
"""
from __future__ import annotations

import argparse
import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np


_PAGE = """<!DOCTYPE html>
<html><head><title>soccernerfs_tpu_torch viewer</title><style>
body { margin:0; background:#111; color:#ddd; font-family:monospace; }
#hud { position:fixed; top:8px; left:8px; background:#000a; padding:8px;
       border-radius:6px; max-width:360px; }
img { width:100vw; height:100vh; object-fit:contain; display:block; }
input[type=range] { width:200px; vertical-align:middle; }
button { margin:1px; }
#kflist div { cursor:pointer; }
#kflist div:hover { color:#fff; }
</style></head><body>
<div id="hud">
  drag: orbit | wheel: zoom | <span id="st"></span><br>
  out: <select id="out"><option>rgb</option><option>depth</option>
       <option>accumulation</option></select>
  fov <input type="range" id="fov" min="20" max="120" step="1" value="60">
  <span id="fovv">60</span><br>
  <span id="trow">t: <input type="range" id="time" min="0" max="1"
       step="0.01" value="0"> <span id="tv">0.00</span></span><br>
  <button id="kf">+ keyframe</button>
  <button id="kfclear">clear</button>
  <button id="preview">preview path</button><br>
  <button id="kfexport">export camera_path.json</button>
  <button id="renderpath">render path</button>
  <span id="kfst">0 keyframes</span>
  <div id="kflist"></div>
  <div id="rst"></div>
  <button id="camtoggle">show cameras</button>
  <button id="kfedit">edit keyframes</button>
  <button id="treetoggle">scene tree</button>
  <button id="exptoggle">export panel</button>
  <button id="logtoggle">logs</button>
  <div id="treepanel" style="display:none"></div>
  <div id="exppanel" style="display:none">
    crop min <input id="cmin" size="10" value="-1 -1 -1">
    max <input id="cmax" size="10" value="1 1 1">
    <button id="expgen">generate commands</button>
    <pre id="expout" style="white-space:pre-wrap"></pre>
  </div>
  <pre id="logpanel" style="display:none; max-height:240px; overflow:auto"></pre>
</div>
<div id="rmodal" style="display:none; position:fixed; top:10vh; left:25vw;
     width:50vw; background:#000d; border:1px solid #6cf; border-radius:8px;
     padding:12px; z-index:10">
  <b>render path</b> <span id="rmst"></span><br>
  <progress id="rmprog" max="1" value="0" style="width:100%"></progress><br>
  <img id="rmimg" style="width:100%; height:auto; min-height:120px;
       object-fit:contain; background:#222">
  <br><button id="rmcancel">cancel</button>
  <button id="rmclose">close</button>
</div>
<canvas id="overlay" style="position:fixed;top:0;left:0;pointer-events:none"></canvas>
<img id="view">
<script>
let az=0.8, el=0.5, radius=2.5, t=0, fov=60, out='rgb';
let busy=false, dirty=true, moving=0, previewing=false;
const img=document.getElementById('view'), st=document.getElementById('st');
document.getElementById('time').oninput=e=>{t=parseFloat(e.target.value);
  document.getElementById('tv').textContent=t.toFixed(2); poke();};
document.getElementById('fov').oninput=e=>{fov=parseFloat(e.target.value);
  document.getElementById('fovv').textContent=fov; poke();};
document.getElementById('out').onchange=e=>{out=e.target.value; poke();};
let drag=false,lx=0,ly=0;
img.onpointerdown=e=>{drag=true;lx=e.clientX;ly=e.clientY;};
window.onpointerup=()=>{drag=false;poke();};
window.onpointermove=e=>{if(!drag)return; az-=(e.clientX-lx)*0.01;
  el+=(e.clientY-ly)*0.01;
  el=Math.max(-1.4,Math.min(1.4,el)); lx=e.clientX; ly=e.clientY; poke();
  drawOverlay();};  // re-project the 3D scene live, no server round-trip
window.onwheel=e=>{radius*=Math.exp(e.deltaY*0.001); poke(); drawOverlay();};
function poke(){ dirty=true; moving=4; }
function c2w(){
  const cx=Math.cos(az)*Math.cos(el)*radius, cy=Math.sin(az)*Math.cos(el)*radius,
        cz=Math.sin(el)*radius;
  const eye=[cx,cy,cz], up=[0,0,1];
  let f=[-cx,-cy,-cz]; const fn=Math.hypot(...f); f=f.map(v=>v/fn);
  let r=[f[1]*up[2]-f[2]*up[1], f[2]*up[0]-f[0]*up[2], f[0]*up[1]-f[1]*up[0]];
  const rn=Math.hypot(...r); r=r.map(v=>v/rn);
  const u=[r[1]*f[2]-r[2]*f[1], r[2]*f[0]-r[0]*f[2], r[0]*f[1]-r[1]*f[0]];
  return [[r[0],u[0],-f[0],eye[0]],[r[1],u[1],-f[1],eye[1]],[r[2],u[2],-f[2],eye[2]]];
}
let override=null;  // {c2w, fov, time} while previewing / jumped to a keyframe
async function fetchFrame(cam, lowres){
  const scale = lowres?4:1;
  const body=JSON.stringify({c2w:cam.c2w, fov:cam.fov,
    width:Math.floor(640/scale), height:Math.floor(360/scale),
    time:cam.time!==undefined?cam.time:t, output:out});
  const r=await fetch('/render',{method:'POST',body});
  return URL.createObjectURL(await r.blob());
}
async function loop(){
  if(dirty&&!busy&&!previewing){
    busy=true; dirty=false;
    const lowres = moving>0; if(moving>0) moving--;
    const cam = override || {c2w:c2w(), fov:fov};
    const t0=performance.now();
    try{
      img.src = await fetchFrame(cam, lowres);
      st.textContent=`${(performance.now()-t0).toFixed(0)}ms ${lowres?'(preview)':''}`;
    }catch(e){ st.textContent='error '+e; }
    busy=false;
    if(moving>0) dirty=true;
  }
  requestAnimationFrame(loop);
}
const kfst=document.getElementById('kfst'), kflist=document.getElementById('kflist');
let kfCache=[], pathCache=[];
async function refreshKfs(){
  const j=await (await fetch('/keyframes')).json();
  kfCache=j.keyframes;
  kfst.textContent=j.keyframes.length+' keyframes';
  kflist.innerHTML='';
  j.keyframes.forEach((k,i)=>{
    const d=document.createElement('div');
    d.textContent=`#${i} fov=${k.fov.toFixed(0)}`+(k.time!==undefined?` t=${k.time.toFixed(2)}`:'');
    d.onclick=()=>{ override={c2w:k.c2w, fov:k.fov, time:k.time}; poke(); };
    const del=document.createElement('button'); del.textContent='x';
    del.onclick=async(e)=>{ e.stopPropagation();
      await fetch('/remove_keyframe',{method:'POST',body:JSON.stringify({index:i})});
      refreshKfs(); };
    d.appendChild(del); kflist.appendChild(d);
  });
  // interpolated 3D path, fetched once per keyframe EDIT and re-projected
  // client-side on every orbit (no per-frame server round-trip)
  if(kfCache.length>1){
    const p=await (await fetch('/path_cameras',{method:'POST',
      body:JSON.stringify({steps_per_transition:16})})).json();
    pathCache=(p.frames||[]).map(f=>[f.c2w[0][3],f.c2w[1][3],f.c2w[2][3]]);
  } else pathCache=[];
  drawOverlay();
}
document.getElementById('kf').onclick=async()=>{
  override=null;
  await fetch('/keyframe',{method:'POST',
    body:JSON.stringify({c2w:c2w(),fov:fov,time:t})});
  refreshKfs();};
document.getElementById('kfclear').onclick=async()=>{
  await fetch('/clear_keyframes',{method:'POST',body:'{}'});
  override=null; refreshKfs();};
document.getElementById('preview').onclick=async()=>{
  const j=await (await fetch('/path_cameras',{method:'POST',
    body:JSON.stringify({steps_per_transition:12})})).json();
  if(!j.frames||!j.frames.length) return;
  previewing=true;
  for(const f of j.frames){
    try{ img.src=await fetchFrame(f, true); }catch(e){ break; }
    await new Promise(res=>setTimeout(res, 40));
  }
  previewing=false; override=null; poke();};
document.getElementById('kfexport').onclick=async()=>{
  const r=await fetch('/export_path',{method:'POST',
    body:JSON.stringify({width:1280,height:720})});
  const j=await r.json();
  document.getElementById('rst').textContent='saved '+(j.path||JSON.stringify(j));};
const rst=document.getElementById('rst');
// ---- render-preview modal (the reference RenderModal surface) ----
const rmodal=document.getElementById('rmodal'), rmst=document.getElementById('rmst'),
      rmprog=document.getElementById('rmprog'), rmimg=document.getElementById('rmimg');
let rmTimer=null;
function rmTick(){
  fetch('/render_status').then(r=>r.json()).then(s=>{
    rmst.textContent=s.running?`frame ${s.frame}/${s.total}`:
      (s.cancelled?'cancelled':(s.path?`wrote ${s.path}`:(s.error||'idle')));
    rmprog.max=s.total||1; rmprog.value=s.frame||0;
    if(s.frame>0) rmimg.src='/render_preview?'+s.frame;
    if(!s.running&&rmTimer){ clearInterval(rmTimer); rmTimer=null; }
  });}
document.getElementById('renderpath').onclick=async()=>{
  const r=await fetch('/render_path',{method:'POST',
    body:JSON.stringify({width:1280,height:720,fps:24,output:out})});
  const j=await r.json();
  if(j.error){ rst.textContent=j.error; return; }
  rmodal.style.display='block'; rmimg.removeAttribute('src');
  if(rmTimer) clearInterval(rmTimer);
  rmTimer=setInterval(rmTick, 500); rmTick();};
document.getElementById('rmcancel').onclick=()=>
  fetch('/cancel_render',{method:'POST',body:'{}'});
document.getElementById('rmclose').onclick=()=>{
  rmodal.style.display='none';
  if(rmTimer){ clearInterval(rmTimer); rmTimer=null; }};
fetch('/scene').then(r=>r.json()).then(j=>{
  if(!j.has_time) document.getElementById('trow').style.display='none';});

// ---- scene context: training-camera frustums + thumbnails (init_scene) ----
let sceneCams=null, showCams=false;
const ovl=document.getElementById('overlay'), ctx=ovl.getContext('2d');
const thumbs={};
document.getElementById('camtoggle').onclick=async()=>{
  showCams=!showCams;
  document.getElementById('camtoggle').textContent=
    showCams?'hide cameras':'show cameras';
  if(showCams&&!sceneCams){
    sceneCams=(await (await fetch('/scene_cameras')).json()).cameras;
    for(const c of sceneCams){ if(c.thumb){ const im=new Image();
      im.src='data:image/jpeg;base64,'+c.thumb; thumbs[c.idx]=im; } }
  }
  drawOverlay();
};
function viewProject(p){
  // world -> current orbit camera (same mapping the server renders with)
  const m=c2w(); // rows of [r u -f eye]
  const d=[p[0]-m[0][3], p[1]-m[1][3], p[2]-m[2][3]];
  const x=d[0]*m[0][0]+d[1]*m[1][0]+d[2]*m[2][0];
  const y=d[0]*m[0][1]+d[1]*m[1][1]+d[2]*m[2][1];
  const z=d[0]*m[0][2]+d[1]*m[1][2]+d[2]*m[2][2];
  if(z>=-1e-6) return null;                      // behind the eye (-z fwd)
  const f=(ovl.height/2)/Math.tan(fov*Math.PI/360);
  return [ovl.width/2 + f*x/(-z), ovl.height/2 - f*y/(-z), -z];
}
// ---- scene tree: server-held visibility toggles ----
let tree={frustums:true, thumbnails:true, labels:true, keyframes:true, path:true};
fetch('/scene_tree').then(r=>r.json()).then(j=>{ tree=j; buildTree(); });
function buildTree(){
  const p=document.getElementById('treepanel'); p.innerHTML='';
  for(const k of Object.keys(tree)){
    const l=document.createElement('label');
    const c=document.createElement('input'); c.type='checkbox'; c.checked=tree[k];
    c.onchange=async()=>{
      tree=await (await fetch('/scene_tree',{method:'POST',
        body:JSON.stringify({[k]:c.checked})})).json();
      drawOverlay();};
    l.appendChild(c); l.appendChild(document.createTextNode(' '+k));
    p.appendChild(l); p.appendChild(document.createElement('br'));
  }}
document.getElementById('treetoggle').onclick=()=>{
  const p=document.getElementById('treepanel');
  p.style.display=p.style.display==='none'?'block':'none';};

// ---- client-side 3D scene + world-space transform gizmo ----
// Everything below projects WORLD geometry through the live orbit camera
// (viewProject) on every redraw: orbiting re-projects grid, frustums,
// path curve and gizmo handles with NO server round-trip (the server is
// only consulted to re-render the underlying image and to persist
// keyframe edits).  The gizmo is the reference app's TransformControls
// surface: world-axis translation arrows + a world-Z rotation ring.
let editKfs=false, kfHandles=[], dragKf=-1, selKf=-1, dragMode=null;
let gizmoHits=[], gizmoRing=null;
const AXES=[[1,0,0],[0,1,0],[0,0,1]], AXCOL=['#f44','#4f4','#48f'];
const GIZMO_LEN=0.35, RING_R=0.28;
document.getElementById('kfedit').onclick=()=>{
  editKfs=!editKfs;
  document.getElementById('kfedit').textContent=
    editKfs?'done editing':'edit keyframes';
  ovl.style.pointerEvents=editKfs?'auto':'none';
  if(!editKfs){ selKf=-1; dragMode=null; }
  drawOverlay();};
function line3(a,b,style,w){
  const pa=viewProject(a), pb=viewProject(b);
  if(!pa||!pb) return null;
  ctx.strokeStyle=style; ctx.lineWidth=w||1; ctx.beginPath();
  ctx.moveTo(pa[0],pa[1]); ctx.lineTo(pb[0],pb[1]); ctx.stroke();
  return [pa,pb];
}
function poly3(pts,style,w){
  ctx.strokeStyle=style; ctx.lineWidth=w||1; ctx.beginPath();
  let started=false;
  for(const q of pts){ const p=viewProject(q);
    if(!p){ started=false; continue; }
    if(!started){ ctx.moveTo(p[0],p[1]); started=true; }
    else ctx.lineTo(p[0],p[1]); }
  ctx.stroke();
}
function drawFrustum(m, fovDeg, aspect, s, color, label){
  // camera wireframe in WORLD space: apex + image plane at distance s
  const a=aspect||1.78;
  const o=[m[0][3],m[1][3],m[2][3]];
  const hw=s*Math.tan(fovDeg*Math.PI/360)*a, hh=s*Math.tan(fovDeg*Math.PI/360);
  const corners=[[-hw,-hh],[hw,-hh],[hw,hh],[-hw,hh]].map(([u,v])=>[
    o[0]+m[0][0]*u+m[0][1]*v-m[0][2]*s,
    o[1]+m[1][0]*u+m[1][1]*v-m[1][2]*s,
    o[2]+m[2][0]*u+m[2][1]*v-m[2][2]*s]);
  const po=viewProject(o), pc=corners.map(viewProject);
  if(!po||pc.some(p=>!p)) return null;
  ctx.strokeStyle=color; ctx.beginPath();
  for(let i=0;i<4;i++){ ctx.moveTo(po[0],po[1]); ctx.lineTo(pc[i][0],pc[i][1]);
    ctx.lineTo(pc[(i+1)%4][0],pc[(i+1)%4][1]); }
  // "up" tick on the top edge so orientation/roll reads at a glance
  const tm=[(pc[2][0]+pc[3][0])/2,(pc[2][1]+pc[3][1])/2];
  ctx.moveTo(tm[0],tm[1]);
  ctx.lineTo(tm[0]+(tm[0]-po[0])*0.12, tm[1]+(tm[1]-po[1])*0.12);
  ctx.stroke();
  if(label){ ctx.fillStyle=color; ctx.fillText(label, po[0]+7, po[1]+3); }
  return po;
}
function drawGizmo(kf){
  const o=[kf.c2w[0][3],kf.c2w[1][3],kf.c2w[2][3]];
  gizmoHits=[]; gizmoRing=null;
  AXES.forEach((ax,i)=>{
    const seg=line3(o,[o[0]+ax[0]*GIZMO_LEN,o[1]+ax[1]*GIZMO_LEN,
                       o[2]+ax[2]*GIZMO_LEN], AXCOL[i],
                    (dragMode&&dragMode.kind==='axis'&&dragMode.axis===i)?4:2.5);
    if(!seg) return;
    ctx.fillStyle=AXCOL[i];
    ctx.fillRect(seg[1][0]-4,seg[1][1]-4,8,8);
    gizmoHits.push({axis:i, x0:seg[0][0], y0:seg[0][1],
                    x1:seg[1][0], y1:seg[1][1]});
  });
  // world-Z rotation ring around the keyframe origin
  const ring=[];
  for(let k=0;k<=40;k++){ const th=k/40*2*Math.PI;
    ring.push([o[0]+Math.cos(th)*RING_R, o[1]+Math.sin(th)*RING_R, o[2]]); }
  poly3(ring,(dragMode&&dragMode.kind==='ring')?'#ff0':'#fc6',
        (dragMode&&dragMode.kind==='ring')?3:1.5);
  const po=viewProject(o), pr=viewProject(ring[0]);
  if(po&&pr) gizmoRing={cx:po[0], cy:po[1],
                        r:Math.hypot(pr[0]-po[0],pr[1]-po[1])};
}
function drawOverlay(){
  ovl.width=window.innerWidth; ovl.height=window.innerHeight;
  ctx.clearRect(0,0,ovl.width,ovl.height);
  if(editKfs){
    // world ground grid (z=0) + axes: the 3D frame the gizmo moves in
    for(let i=-2;i<=2;i++){
      line3([i,-2,0],[i,2,0],'#333',1); line3([-2,i,0],[2,i,0],'#333',1); }
    line3([0,0,0],[0.5,0,0],'#f44',2); line3([0,0,0],[0,0.5,0],'#4f4',2);
    line3([0,0,0],[0,0,0.5],'#48f',2);
  }
  if(showCams&&sceneCams&&tree.frustums){
    ctx.lineWidth=1; ctx.font='9px monospace';
    for(const c of sceneCams){
      const po=drawFrustum(c.c2w, c.fov, c.aspect, 0.25, '#6cf',
                           tree.labels?('#'+c.idx):null);
      if(!po) continue;
      const im=thumbs[c.idx], a=c.aspect||1.78;
      if(tree.thumbnails&&im&&im.complete){ const w=Math.max(12, 900/po[2]);
        ctx.drawImage(im, po[0]-w/2, po[1]-w/(2*a), w, w/a); }
    }
  }
  kfHandles=[];
  if(tree.keyframes&&kfCache.length){
    // interpolated 3D path curve, re-projected through the live camera
    if(tree.path){
      if(pathCache.length>1) poly3(pathCache,'#fc6',1.5);
      else if(kfCache.length>1)
        poly3(kfCache.map(k=>[k.c2w[0][3],k.c2w[1][3],k.c2w[2][3]]),'#fc6',1.5);
    }
    ctx.font='10px monospace'; ctx.lineWidth=1;
    kfCache.forEach((k,i)=>{
      const col=(i===selKf)?'#ff0':(editKfs?'#f80':'#fc6');
      const po=drawFrustum(k.c2w, k.fov, 1.78, 0.18, col, 'kf'+i);
      if(!po) return;
      kfHandles.push({i, x:po[0], y:po[1], depth:po[2]});
      ctx.fillStyle=col; ctx.fillRect(po[0]-5,po[1]-5,10,10);
    });
    if(editKfs&&selKf>=0&&kfCache[selKf]) drawGizmo(kfCache[selKf]);
  }
}
function distSeg(px,py,h){
  const dx=h.x1-h.x0, dy=h.y1-h.y0, l2=dx*dx+dy*dy;
  const t=l2?Math.max(0,Math.min(1,((px-h.x0)*dx+(py-h.y0)*dy)/l2)):0;
  return Math.hypot(px-(h.x0+t*dx), py-(h.y0+t*dy));
}
ovl.onpointerdown=e=>{
  if(!editKfs) return;
  if(selKf>=0){
    for(const h of gizmoHits){
      if(distSeg(e.clientX,e.clientY,h)<7){
        dragMode={kind:'axis', axis:h.axis};
        lx=e.clientX; ly=e.clientY; drawOverlay(); return; } }
    if(gizmoRing&&Math.abs(Math.hypot(e.clientX-gizmoRing.cx,
        e.clientY-gizmoRing.cy)-gizmoRing.r)<8){
      dragMode={kind:'ring',
        a0:Math.atan2(e.clientY-gizmoRing.cy, e.clientX-gizmoRing.cx)};
      drawOverlay(); return; }
  }
  for(const h of kfHandles){
    if(Math.abs(e.clientX-h.x)<8&&Math.abs(e.clientY-h.y)<8){
      selKf=h.i; dragKf=h.i; lx=e.clientX; ly=e.clientY;
      drawOverlay(); return; } }
  selKf=-1; dragMode=null; drawOverlay();
};
ovl.onpointermove=e=>{
  if(dragMode&&selKf>=0){
    const kf=kfCache[selKf];
    if(dragMode.kind==='axis'){
      // world-axis translation: screen delta projected onto the axis's
      // SCREEN direction, scaled back to world units via the projected
      // gizmo arm length
      const h=gizmoHits.find(q=>q.axis===dragMode.axis); if(!h) return;
      const dxs=h.x1-h.x0, dys=h.y1-h.y0, len2=dxs*dxs+dys*dys;
      if(len2<1) return;
      const tpx=((e.clientX-lx)*dxs+(e.clientY-ly)*dys)/len2;
      lx=e.clientX; ly=e.clientY;
      const ax=AXES[dragMode.axis];
      for(let r=0;r<3;r++) kf.c2w[r][3]+=ax[r]*tpx*GIZMO_LEN;
    }else{
      // world-Z rotation: pointer angle change around the projected
      // origin, sign flipped when viewing the plane from below
      if(!gizmoRing) return;
      const a1=Math.atan2(e.clientY-gizmoRing.cy, e.clientX-gizmoRing.cx);
      let dth=a1-dragMode.a0;
      if(dth>Math.PI) dth-=2*Math.PI; if(dth<-Math.PI) dth+=2*Math.PI;
      dragMode.a0=a1;
      const sgn=(el>=0)?-1:1, c=Math.cos(sgn*dth), s=Math.sin(sgn*dth);
      for(let col=0;col<3;col++){
        const x=kf.c2w[0][col], y=kf.c2w[1][col];
        kf.c2w[0][col]=c*x-s*y; kf.c2w[1][col]=s*x+c*y;
      }
    }
    drawOverlay(); return;
  }
  if(dragKf<0) return;
  const h=kfHandles.find(q=>q.i===dragKf); if(!h) return;
  // free drag (no gizmo handle): screen-plane move at the handle's depth
  const m=c2w(), f=(ovl.height/2)/Math.tan(fov*Math.PI/360);
  const s=h.depth/f, du=(e.clientX-lx)*s, dv=(e.clientY-ly)*s;
  lx=e.clientX; ly=e.clientY;
  const kf=kfCache[dragKf];
  for(let r=0;r<3;r++)
    kf.c2w[r][3]+=m[r][0]*du-m[r][1]*dv;  // right*du + up*(-dv)
  drawOverlay();
};
ovl.onpointerup=async e=>{
  if(dragMode&&selKf>=0){
    const i=selKf; dragMode=null;
    await fetch('/update_keyframe',{method:'POST',
      body:JSON.stringify({index:i, c2w:kfCache[i].c2w})});
    refreshKfs(); poke(); return;
  }
  if(dragKf<0) return;
  const i=dragKf; dragKf=-1;
  await fetch('/update_keyframe',{method:'POST',
    body:JSON.stringify({index:i, c2w:kfCache[i].c2w})});
  refreshKfs(); poke();
};
setInterval(()=>{ if(showCams||tree.keyframes||editKfs) drawOverlay(); }, 120);

// ---- ExportPanel: generate snt-render / snt-export commands ----
document.getElementById('exptoggle').onclick=()=>{
  const p=document.getElementById('exppanel');
  p.style.display=p.style.display==='none'?'block':'none';};
document.getElementById('expgen').onclick=async()=>{
  const mn=document.getElementById('cmin').value.trim().split(/\\s+/).map(Number);
  const mx=document.getElementById('cmax').value.trim().split(/\\s+/).map(Number);
  const j=await (await fetch('/export_commands',{method:'POST',
    body:JSON.stringify({crop:{min:mn,max:mx}})})).json();
  document.getElementById('expout').textContent=
    Object.values(j).join('\\n\\n');};

// ---- LogPanel: recent train metrics + viewer events ----
let showLogs=false;
document.getElementById('logtoggle').onclick=()=>{
  showLogs=!showLogs;
  document.getElementById('logpanel').style.display=showLogs?'block':'none';};
setInterval(async()=>{ if(!showLogs) return;
  const j=await (await fetch('/logs')).json();
  const lp=document.getElementById('logpanel');
  lp.textContent=j.logs.join('\\n'); lp.scrollTop=lp.scrollHeight; }, 2000);

poke(); loop(); refreshKfs();
// introspection hook for the browser-driven e2e check (script-scoped
// lets are otherwise unreachable from the console)
window.__dbg=()=>({kfHandles, gizmoHits, gizmoRing, selKf, editKfs,
                   nPath:pathCache.length, az, el, radius});
</script></body></html>"""



def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


class ViewerState:
    """The trainer (at a loaded snapshot), the keyframes and the background
    render job; renders hold ``lock``."""

    def __init__(self, trainer, output_dir: Path | None = None):
        self.trainer = trainer
        self.lock = threading.Lock()
        self.keyframes: list = []
        self.output_dir = Path(output_dir) if output_dir else Path.cwd()
        self.render_job: dict = {"running": False, "frame": 0, "total": 0}
        self.scene_tree: dict = {
            "frustums": True, "thumbnails": True, "labels": True,
            "keyframes": True, "path": True,
        }
        self._logs: list = []
        self._log_lock = threading.Lock()
        # the writer's scalar events show in the log panel
        from soccernerfs_tpu_torch.utils import writer

        state = self

        class _ViewerSink(writer.Writer):
            def write_scalar(self, name, scalar, step):
                state.log(f"step {step} {name}: {scalar:.4g}")

            def write_image(self, name, image, step):
                state.log(f"step {step} {name}: image {image.shape}")

        writer._SINKS.append(_ViewerSink())

    def add_keyframe(self, c2w, fov, time=None) -> int:
        kf = {"c2w": c2w, "fov": float(fov)}
        if time is not None:
            kf["time"] = float(time)
        self.keyframes.append(kf)
        return len(self.keyframes)

    def update_keyframe(self, index, c2w=None, fov=None, time=None) -> dict:
        """Edit keyframe ``index`` in place (the page's keyframe gizmos)."""
        if not 0 <= index < len(self.keyframes):
            return {"error": f"no keyframe {index}"}
        kf = self.keyframes[index]
        if c2w is not None:
            try:
                arr = np.asarray(c2w, dtype=np.float64)
            except (TypeError, ValueError):
                return {"error": "c2w must be a numeric nested list"}
            if arr.shape not in ((3, 4), (4, 4)) or not np.isfinite(arr).all():
                return {"error": f"c2w must be 3x4 or 4x4 finite, got {arr.shape}"}
            kf["c2w"] = arr[:3].tolist()
        if fov is not None:
            kf["fov"] = float(fov)
        if time is not None:
            kf["time"] = float(time)
        return {"keyframe": kf, "index": index}

    def set_scene_tree(self, updates: dict | None = None) -> dict:
        """The scene-tree panel's visibility switches (frustums,
        thumbnails, labels, keyframes, path), held by the server."""
        if updates:
            for k, v in updates.items():
                if k in self.scene_tree:
                    self.scene_tree[k] = bool(v)
        return dict(self.scene_tree)

    def cancel_render(self) -> dict:
        with self.lock:
            if not self.render_job.get("running"):
                return {"error": "no render running"}
            self.render_job["cancel"] = True
        return {"cancelling": True}

    def render_status(self) -> dict:
        # the preview frame's bytes stay out of the JSON status
        return {
            k: v for k, v in self.render_job.items() if not k.startswith("_")
        }

    def render_preview(self) -> bytes | None:
        return self.render_job.get("_preview")

    def path_cameras(self, steps_per_transition: int = 12) -> list:
        """The keyframe path's interpolated frames for the page's preview
        (host geometry only: nothing is rendered)."""
        from soccernerfs_tpu_torch.core.camera_paths import (
            get_path_from_json,
            keyframes_to_camera_path_json,
        )

        if len(self.keyframes) < 2:
            return [dict(k) for k in self.keyframes]
        payload = keyframes_to_camera_path_json(
            self.keyframes, 640, 360, steps_per_transition, 24
        )
        cams = get_path_from_json(payload, device="cpu")
        c2ws, fys, hs = (_host(cams.camera_to_worlds), _host(cams.fy),
                         _host(cams.height))
        times = None if cams.times is None else _host(cams.times)
        frames = []
        for i in range(cams.num_cameras):
            frames.append({
                "c2w": c2ws[i].tolist(),
                "fov": float(np.rad2deg(2 * np.arctan(float(hs[i]) / 2
                                                      / float(fys[i])))),
                **({"time": float(times[i])} if times is not None else {}),
            })
        return frames

    def export_path(self, width=1280, height=720, steps_per_transition=24,
                    fps=24) -> dict:
        from soccernerfs_tpu_torch.core.camera_paths import keyframes_to_camera_path_json

        if not self.keyframes:
            return {"error": "no keyframes"}
        payload = keyframes_to_camera_path_json(
            self.keyframes, width, height, steps_per_transition, fps
        )
        out = self.output_dir / "camera_path.json"
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(payload))
        payload_meta = dict(payload)
        payload_meta["path"] = str(out)
        return payload_meta

    def start_render_path(self, width=1280, height=720, fps=24,
                          output="rgb", steps_per_transition=24) -> dict:
        """Render the keyframe path on a background thread (the page's
        render modal)."""
        # check and set under the lock: two concurrent /render_path
        # requests must not both start
        with self.lock:
            if self.render_job.get("running"):
                return {"error": "render already running"}
            if len(self.keyframes) < 2:
                return {"error": "need >= 2 keyframes"}
            self.render_job = {"running": True, "frame": 0, "total": 0}
        from soccernerfs_tpu_torch.core.camera_paths import (
            get_path_from_json,
            keyframes_to_camera_path_json,
        )

        try:
            payload = keyframes_to_camera_path_json(
                self.keyframes, width, height, steps_per_transition, fps
            )
            cams = get_path_from_json(payload, device=self.trainer.device)
        except Exception:
            self.render_job = {"running": False, "frame": 0, "total": 0}
            raise
        out_path = self.output_dir / "renders" / "viewer_path.mp4"
        self.render_job = {
            "running": True, "frame": 0, "total": int(cams.num_cameras)
        }

        def run():
            from PIL import Image

            try:
                frames = []
                for i in range(cams.num_cameras):
                    if self.render_job.get("cancel"):
                        self.render_job["cancelled"] = True
                        return
                    with self.lock:
                        outputs = self.trainer.render_camera(cams, i)
                    frames.append(self._to_rgb8(outputs, output))
                    self.render_job["frame"] = i + 1
                    # the latest frame as JPEG for the render modal
                    buf = io.BytesIO()
                    Image.fromarray(frames[-1]).save(buf, format="JPEG",
                                                     quality=80)
                    self.render_job["_preview"] = buf.getvalue()
                out_path.parent.mkdir(parents=True, exist_ok=True)
                try:
                    import imageio

                    imageio.mimwrite(str(out_path), frames, fps=fps)
                    self.render_job["path"] = str(out_path)
                except Exception:
                    stem = out_path.with_suffix("")
                    stem.mkdir(parents=True, exist_ok=True)
                    for i, f in enumerate(frames):
                        Image.fromarray(f).save(stem / f"{i:05d}.png")
                    self.render_job["path"] = str(stem)
            except Exception as e:
                self.render_job["error"] = str(e)
            finally:
                self.render_job["running"] = False

        threading.Thread(target=run, daemon=True).start()
        return {"started": True, "total": int(cams.num_cameras)}

    @staticmethod
    def _to_rgb8(outputs: dict, output: str) -> np.ndarray:
        from soccernerfs_tpu_torch.utils.colormaps import (
            apply_colormap,
            apply_depth_colormap,
        )

        if output == "depth":
            img = apply_depth_colormap(
                outputs["depth"], outputs.get("accumulation")
            )
        elif output == "accumulation":
            img = apply_colormap(outputs["accumulation"])
        else:
            img = outputs["rgb"]
        return (np.clip(np.asarray(img), 0, 1) * 255).astype(np.uint8)

    def render(self, c2w, fov_deg, width, height, time=None,
               output: str = "rgb") -> bytes:
        """A PNG of one camera (vertical fov in degrees, centred principal
        point) at the snapshot, rendered on the trainer's device."""
        from PIL import Image

        from soccernerfs_tpu_torch.core.cameras import Cameras

        focal = height / 2.0 / np.tan(np.deg2rad(fov_deg) / 2.0)
        cams = Cameras.create(
            camera_to_worlds=np.asarray(c2w, np.float32)[None],
            fx=focal,
            fy=focal,
            cx=width / 2.0,
            cy=height / 2.0,
            width=width,
            height=height,
            times=None if time is None else np.asarray([time], np.float32),
            device=self.trainer.device,
        )
        with self.lock:
            outputs = self.trainer.render_camera(cams, 0)
        rgb = self._to_rgb8(outputs, output)
        buf = io.BytesIO()
        Image.fromarray(rgb).save(buf, format="PNG")
        return buf.getvalue()

    def scene_meta(self) -> dict:
        cams = self.trainer.train_cameras
        return {
            "num_cameras": int(cams.num_cameras),
            "has_time": cams.times is not None,
            "aabb": _host(self.trainer.aabb).tolist(),
        }

    def scene_cameras(self, max_cameras: int = 100, thumb_px: int = 48) -> dict:
        """Training-camera frustums with JPEG thumbnails of their images,
        for the page's 3D scene."""
        import base64

        from PIL import Image

        cams = self.trainer.train_cameras
        n = int(cams.num_cameras)
        idxs = np.unique(
            np.linspace(0, n - 1, min(n, max_cameras)).astype(int)
        )
        dataset = getattr(
            getattr(self.trainer, "datamanager", None), "train_dataset", None
        )
        c2ws = _host(cams.camera_to_worlds)
        fys = _host(cams.fy).reshape(-1)
        hs = _host(cams.height).reshape(-1)
        ws = _host(cams.width).reshape(-1)
        out = []
        for i in idxs:
            entry = {
                "idx": int(i),
                "c2w": c2ws[i].tolist(),
                "fov": float(np.rad2deg(2 * np.arctan(hs[i] / 2.0 / fys[i]))),
                "aspect": float(ws[i] / hs[i]),
            }
            if dataset is not None:
                # a camera whose image cannot be read keeps its frustum
                try:
                    img = np.asarray(dataset.get_image(int(i)))
                except OSError:
                    img = None
                if img is not None:
                    pil = Image.fromarray(
                        (np.clip(img[..., :3], 0, 1) * 255).astype(np.uint8)
                    )
                    pil.thumbnail((thumb_px, thumb_px))
                    buf = io.BytesIO()
                    pil.save(buf, format="JPEG", quality=70)
                    entry["thumb"] = base64.b64encode(buf.getvalue()).decode()
            out.append(entry)
        return {"cameras": out}

    def export_commands(self, crop: dict | None = None) -> dict:
        """Shell commands for this run (the page's export panel): the
        render of the exported camera path, the point cloud and the
        Poisson mesh.  A crop box adds ``--bbox-min/--bbox-max`` to the
        exports, as the JAX server writes them; neither exporter takes
        those flags (a trap shared with the reference), so only a command
        without a crop runs as written."""
        config = self.output_dir / "config.yml"
        path_json = self.output_dir / "camera_path.json"
        crop_args = ""
        if crop:
            lo = [float(v) for v in crop.get("min", (-1, -1, -1))]
            hi = [float(v) for v in crop.get("max", (1, 1, 1))]
            crop_args = (
                f" --bbox-min {lo[0]} {lo[1]} {lo[2]}"
                f" --bbox-max {hi[0]} {hi[1]} {hi[2]}"
            )
        return {
            "render": (
                f"python -m soccernerfs_tpu_torch.scripts.render "
                f"--load-config {config} --traj filename "
                f"--camera-path-filename {path_json} "
                f"--output-path renders/output.mp4"
            ),
            "export_pointcloud": (
                f"python -m soccernerfs_tpu_torch.scripts.exporter pointcloud "
                f"--load-config {config} "
                f"--output-dir exports/pcd{crop_args}"
            ),
            "export_mesh": (
                f"python -m soccernerfs_tpu_torch.scripts.exporter poisson "
                f"--load-config {config} "
                f"--output-dir exports/mesh{crop_args}"
            ),
        }

    def recent_logs(self, limit: int = 200) -> list:
        """The latest writer scalars and viewer events (the log panel)."""
        with self._log_lock:
            return list(self._logs)[-limit:]

    def log(self, msg: str) -> None:
        import time as _time

        with self._log_lock:
            self._logs.append(
                f"{_time.strftime('%H:%M:%S')} {msg}"
            )
            if len(self._logs) > 1000:
                del self._logs[:500]


def make_handler(state: ViewerState):
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
            if self.path == "/":
                self._send(200, _PAGE.encode(), "text/html")
            elif self.path == "/scene":
                self._send(200, json.dumps(state.scene_meta()).encode())
            elif self.path == "/keyframes":
                self._send(
                    200, json.dumps({"keyframes": state.keyframes}).encode()
                )
            elif self.path == "/render_status":
                self._send(200, json.dumps(state.render_status()).encode())
            elif self.path == "/render_preview":
                preview = state.render_preview()
                if preview:
                    self._send(200, preview, "image/jpeg")
                else:
                    self._send(404, b"{}")
            elif self.path == "/scene_tree":
                self._send(200, json.dumps(state.set_scene_tree()).encode())
            elif self.path == "/scene_cameras":
                self._send(200, json.dumps(state.scene_cameras()).encode())
            elif self.path == "/logs":
                self._send(
                    200, json.dumps({"logs": state.recent_logs()}).encode()
                )
            else:
                self._send(404, b"{}")

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(length) or b"{}")
            try:
                if self.path == "/render":
                    png = state.render(
                        req["c2w"],
                        req.get("fov", 60.0),
                        int(req.get("width", 640)),
                        int(req.get("height", 360)),
                        req.get("time"),
                        req.get("output", "rgb"),
                    )
                    self._send(200, png, "image/png")
                elif self.path == "/keyframe":
                    count = state.add_keyframe(
                        req["c2w"], req.get("fov", 60.0), req.get("time")
                    )
                    self._send(200, json.dumps({"count": count}).encode())
                elif self.path == "/update_keyframe":
                    payload = state.update_keyframe(
                        int(req["index"]), req.get("c2w"),
                        req.get("fov"), req.get("time"),
                    )
                    self._send(200, json.dumps(payload).encode())
                elif self.path == "/scene_tree":
                    payload = state.set_scene_tree(req)
                    self._send(200, json.dumps(payload).encode())
                elif self.path == "/cancel_render":
                    self._send(
                        200, json.dumps(state.cancel_render()).encode()
                    )
                elif self.path == "/remove_keyframe":
                    idx = int(req["index"])
                    if 0 <= idx < len(state.keyframes):
                        state.keyframes.pop(idx)
                    self._send(200, json.dumps(
                        {"count": len(state.keyframes)}).encode())
                elif self.path == "/clear_keyframes":
                    state.keyframes.clear()
                    self._send(200, b"{}")
                elif self.path == "/path_cameras":
                    frames = state.path_cameras(
                        int(req.get("steps_per_transition", 12))
                    )
                    self._send(
                        200, json.dumps({"frames": frames}).encode()
                    )
                elif self.path == "/export_path":
                    payload = state.export_path(
                        int(req.get("width", 1280)),
                        int(req.get("height", 720)),
                        int(req.get("steps_per_transition", 24)),
                        int(req.get("fps", 24)),
                    )
                    self._send(200, json.dumps(payload).encode())
                elif self.path == "/export_commands":
                    payload = state.export_commands(req.get("crop"))
                    self._send(200, json.dumps(payload).encode())
                elif self.path == "/render_path":
                    payload = state.start_render_path(
                        int(req.get("width", 1280)),
                        int(req.get("height", 720)),
                        int(req.get("fps", 24)),
                        req.get("output", "rgb"),
                        int(req.get("steps_per_transition", 24)),
                    )
                    self._send(200, json.dumps(payload).encode())
                else:
                    self._send(404, b"{}")
            except Exception as e:  # the client shows the error
                self._send(500, json.dumps({"error": str(e)}).encode())

    return Handler


def make_server(trainer, host: str = "0.0.0.0", port: int = 7007,
                output_dir=None) -> ThreadingHTTPServer:
    """The viewer's threaded HTTP server over ``trainer``, bound to
    (``host``, ``port``; 0 picks a free port, ``server.server_address``
    names it) and not yet serving: call ``serve_forever``, and
    ``shutdown`` from another thread.  ``server.viewer_state`` is its
    ``ViewerState``, whose ``lock`` every render holds."""
    state = ViewerState(trainer, output_dir)
    server = ThreadingHTTPServer((host, port), make_handler(state))
    server.viewer_state = state
    return server


def serve(trainer, port: int = 7007, output_dir=None):
    server = make_server(trainer, "0.0.0.0", port, output_dir)
    print(f"[viewer] serving on http://localhost:{port}")
    server.serve_forever()


def main(argv=None, device=None):
    """Serve the run of ``--load-config``.  ``device``: default CUDA;
    raises when CUDA is absent and the caller did not ask for another
    device."""
    parser = argparse.ArgumentParser("snt-viewer")
    parser.add_argument("--load-config", type=Path, required=True)
    parser.add_argument("--port", type=int, default=7007)
    args = parser.parse_args(argv)

    from soccernerfs_tpu_torch.utils.eval_utils import eval_setup

    _, trainer, _ = eval_setup(args.load_config, "inference", device=device)
    serve(trainer, args.port, output_dir=args.load_config.parent)


if __name__ == "__main__":
    main()
