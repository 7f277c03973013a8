"""Interactive 3D scene artifact (port of ``mvsdf_tpu/eval/html_viewer.py``):
a single self-contained HTML file with the extracted surface mesh, camera
viewing cones, and an optional traced-point scatter, rendered by an
embedded vanilla-WebGL orbit viewer.

Behavioral parity target: the reference's plotly HTML scene plot
(``code/utils/plots.py:12-65`` — ``get_surface_trace`` mesh +
``get_3D_quiver_trace`` camera cones + ``get_3D_scatter_trace`` points).
The viewer needs neither plotly nor the network: it ships its own
~150-line WebGL renderer inline (no CDN scripts); mesh data is embedded
as base64 typed arrays.

Controls: drag = orbit, wheel = zoom, shift/right-drag = pan.
"""
from __future__ import annotations

import base64

import numpy as np

from .plots import _camera_cone_lines


def _b64(arr: np.ndarray) -> str:
    return base64.b64encode(np.ascontiguousarray(arr).tobytes()).decode()


_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>MVSDF scene</title><style>
html,body{margin:0;height:100%;overflow:hidden;background:#101018}
canvas{width:100%;height:100%;display:block}
#hud{position:fixed;top:8px;left:10px;color:#9ab;font:12px monospace}
</style></head><body>
<div id="hud">__TITLE__ &mdash; drag: orbit &middot; wheel: zoom &middot;
shift-drag: pan</div>
<canvas id="c"></canvas>
<script>
"use strict";
function decode(b64, T){const s=atob(b64);const u=new Uint8Array(s.length);
for(let i=0;i<s.length;i++)u[i]=s.charCodeAt(i);return new T(u.buffer);}
const V=decode("__V__",Float32Array);      // interleaved pos(3)+color(3)
const F=decode("__F__",Uint32Array);       // triangle indices
const L=decode("__L__",Float32Array);      // line segment endpoints (xyz)
const P=decode("__P__",Float32Array);      // scatter points (xyz)
const CENTER=__CENTER__, RADIUS=__RADIUS__;

const gl=document.getElementById("c").getContext("webgl",{antialias:true});
gl.getExtension("OES_element_index_uint");
gl.getExtension("OES_standard_derivatives"); // before compiling meshP
function sh(type,src){const s=gl.createShader(type);gl.shaderSource(s,src);
gl.compileShader(s);if(!gl.getShaderParameter(s,gl.COMPILE_STATUS))
throw gl.getShaderInfoLog(s);return s;}
function prog(vs,fs){const p=gl.createProgram();
gl.attachShader(p,sh(gl.VERTEX_SHADER,vs));
gl.attachShader(p,sh(gl.FRAGMENT_SHADER,fs));gl.linkProgram(p);return p;}
const meshVS=
`attribute vec3 pos;attribute vec3 col;uniform mat4 mvp;uniform mat4 mv;
varying vec3 vc;varying vec3 vp;
void main(){gl_Position=mvp*vec4(pos,1.);vc=col;
vp=(mv*vec4(pos,1.)).xyz;}`;
let meshP;
try{meshP=prog(meshVS,
`#extension GL_OES_standard_derivatives : enable
precision mediump float;varying vec3 vc;varying vec3 vp;
void main(){vec3 n=normalize(cross(dFdx(vp),dFdy(vp)));
float l=.35+.65*abs(n.z);gl_FragColor=vec4(vc*l,1.);}`);}
catch(e){ // no derivatives extension: unlit vertex colors
meshP=prog(meshVS,
`precision mediump float;varying vec3 vc;varying vec3 vp;
void main(){gl_FragColor=vec4(vc,1.);}`);}
const flatP=prog(
`attribute vec3 pos;uniform mat4 mvp;uniform float psz;
void main(){gl_Position=mvp*vec4(pos,1.);gl_PointSize=psz;}`,
`precision mediump float;uniform vec4 ucol;
void main(){gl_FragColor=ucol;}`);

function buf(target,data){const b=gl.createBuffer();gl.bindBuffer(target,b);
gl.bufferData(target,data,gl.STATIC_DRAW);return b;}
const vb=buf(gl.ARRAY_BUFFER,V), ib=buf(gl.ELEMENT_ARRAY_BUFFER,F);
const lb=L.length?buf(gl.ARRAY_BUFFER,L):null;
const pb=P.length?buf(gl.ARRAY_BUFFER,P):null;

// --- minimal mat4 ---
function mul(a,b){const o=new Float32Array(16);
for(let i=0;i<4;i++)for(let j=0;j<4;j++){let s=0;
for(let k=0;k<4;k++)s+=a[k*4+j]*b[i*4+k];o[i*4+j]=s;}return o;}
function persp(fov,asp,n,f){const t=1/Math.tan(fov/2);
return new Float32Array([t/asp,0,0,0, 0,t,0,0, 0,0,(f+n)/(n-f),-1,
0,0,2*f*n/(n-f),0]);}
function lookAtView(az,el,dist,pan){
const ce=Math.cos(el),se=Math.sin(el),ca=Math.cos(az),sa=Math.sin(az);
const eye=[dist*ce*ca,dist*se,dist*ce*sa];
const fwd=[-ce*ca,-se,-ce*sa];
let up=[0,1,0];
const rt=norm3(cross(fwd,up)); up=cross(rt,fwd);
const tx=CENTER[0]+pan[0]*rt[0]+pan[1]*up[0];
const ty=CENTER[1]+pan[0]*rt[1]+pan[1]*up[1];
const tz=CENTER[2]+pan[0]*rt[2]+pan[1]*up[2];
const ex=eye[0]+tx,ey=eye[1]+ty,ez=eye[2]+tz;
return new Float32Array([rt[0],up[0],-fwd[0],0, rt[1],up[1],-fwd[1],0,
rt[2],up[2],-fwd[2],0,
-(rt[0]*ex+rt[1]*ey+rt[2]*ez),
-(up[0]*ex+up[1]*ey+up[2]*ez),
fwd[0]*ex+fwd[1]*ey+fwd[2]*ez,1]);}
function cross(a,b){return [a[1]*b[2]-a[2]*b[1],a[2]*b[0]-a[0]*b[2],
a[0]*b[1]-a[1]*b[0]];}
function norm3(v){const l=Math.hypot(v[0],v[1],v[2])||1;
return [v[0]/l,v[1]/l,v[2]/l];}

let az=0.9,el=0.5,dist=RADIUS*3,pan=[0,0],drag=0,px=0,py=0,panning=false;
const cv=gl.canvas;
cv.addEventListener("mousedown",e=>{drag=1;px=e.clientX;py=e.clientY;
panning=e.shiftKey||e.button===2;});
window.addEventListener("mouseup",()=>drag=0);
window.addEventListener("mousemove",e=>{if(!drag)return;
const dx=e.clientX-px,dy=e.clientY-py;px=e.clientX;py=e.clientY;
if(panning){pan[0]-=dx*dist*0.0015;pan[1]+=dy*dist*0.0015;}
else{az+=dx*0.008;el=Math.min(1.5,Math.max(-1.5,el+dy*0.008));}
draw();});
cv.addEventListener("wheel",e=>{e.preventDefault();
dist*=Math.exp(e.deltaY*0.001);draw();},{passive:false});
cv.addEventListener("contextmenu",e=>e.preventDefault());

function draw(){
const w=cv.clientWidth,h=cv.clientHeight;
if(cv.width!==w||cv.height!==h){cv.width=w;cv.height=h;}
gl.viewport(0,0,w,h);gl.clearColor(0.063,0.063,0.094,1);
gl.enable(gl.DEPTH_TEST);
gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
const mv=lookAtView(az,el,dist,pan);
const mvp=mul(persp(0.8,w/h,RADIUS*0.01,RADIUS*40),mv);
// mesh
gl.useProgram(meshP);
gl.uniformMatrix4fv(gl.getUniformLocation(meshP,"mvp"),false,mvp);
gl.uniformMatrix4fv(gl.getUniformLocation(meshP,"mv"),false,mv);
gl.bindBuffer(gl.ARRAY_BUFFER,vb);
const ap=gl.getAttribLocation(meshP,"pos"),
ac=gl.getAttribLocation(meshP,"col");
gl.enableVertexAttribArray(ap);gl.vertexAttribPointer(ap,3,gl.FLOAT,0,24,0);
gl.enableVertexAttribArray(ac);
gl.vertexAttribPointer(ac,3,gl.FLOAT,0,24,12);
gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER,ib);
gl.drawElements(gl.TRIANGLES,F.length,gl.UNSIGNED_INT,0);
gl.disableVertexAttribArray(ac);
// camera cones
gl.useProgram(flatP);
gl.uniformMatrix4fv(gl.getUniformLocation(flatP,"mvp"),false,mvp);
const fp=gl.getAttribLocation(flatP,"pos");
if(lb){gl.bindBuffer(gl.ARRAY_BUFFER,lb);
gl.enableVertexAttribArray(fp);gl.vertexAttribPointer(fp,3,gl.FLOAT,0,0,0);
gl.uniform4f(gl.getUniformLocation(flatP,"ucol"),0.91,0.2,0.32,1);
gl.uniform1f(gl.getUniformLocation(flatP,"psz"),1.0);
gl.drawArrays(gl.LINES,0,L.length/3);}
if(pb){gl.bindBuffer(gl.ARRAY_BUFFER,pb);
gl.enableVertexAttribArray(fp);gl.vertexAttribPointer(fp,3,gl.FLOAT,0,0,0);
gl.uniform4f(gl.getUniformLocation(flatP,"ucol"),1.0,0.45,0.25,1);
gl.uniform1f(gl.getUniformLocation(flatP,"psz"),2.5);
gl.drawArrays(gl.POINTS,0,P.length/3);}
}
window.addEventListener("resize",draw);
draw();
</script></body></html>
"""


def write_scene_html(path, verts, faces, poses=None, vert_colors=None,
                     points=None, max_faces=200_000, max_points=20_000,
                     title="MVSDF scene"):
    """Write the interactive scene artifact.

    verts (V, 3) float; faces (F, 3) int; poses optional (N, 4, 4)
    camera-to-world (drawn as wireframe viewing cones, ref
    plots.py:67-111); vert_colors optional (V,) scalars in [0, 1]
    (surface-indicator sigmoid, mapped like the reference's vertex
    colors, ref plots.py:179-203) or (V, 3) RGB in [0, 1]; points
    optional (M, 3) scatter (traced intersections, ref plots.py:37-44).
    """
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.uint32)
    if len(faces) > max_faces:
        sel = np.random.default_rng(0).choice(len(faces), size=max_faces,
                                              replace=False)
        faces = faces[sel]

    if vert_colors is None:
        col = np.full_like(verts, 0.75, dtype=np.float32)
        col[:, 2] = 0.9  # bluish default like the PNG snapshot
    else:
        vc = np.asarray(vert_colors, np.float32)
        if vc.ndim == 1:
            # reference bakes indicator into the RED channel
            # (ref plots.py:200-203: [s, 1-s, 0] per vertex)
            vc = np.clip(vc, 0.0, 1.0)
            col = np.stack([vc, 1.0 - vc, np.zeros_like(vc)], -1)
        else:
            col = np.clip(vc, 0.0, 1.0)
    inter = np.concatenate([verts, col.astype(np.float32)], -1)

    seg = np.zeros((0, 3), np.float32)
    if poses is not None and len(poses):
        lines = []
        for p in np.asarray(poses):
            lines.extend(_camera_cone_lines(p))
        seg = np.asarray(lines, np.float32).reshape(-1, 3)

    pts = np.zeros((0, 3), np.float32)
    if points is not None and len(points):
        pts = np.asarray(points, np.float32)
        if len(pts) > max_points:
            sel = np.random.default_rng(1).choice(len(pts), size=max_points,
                                                  replace=False)
            pts = pts[sel]

    allpts = [verts] if len(verts) else []
    if len(seg):
        allpts.append(seg)
    if allpts:
        ap = np.concatenate(allpts, 0)
        lo, hi = ap.min(0), ap.max(0)
        center = ((lo + hi) / 2).tolist()
        radius = float(np.linalg.norm(hi - lo) / 2) + 1e-6
    else:
        center, radius = [0.0, 0.0, 0.0], 1.0

    html = (_TEMPLATE
            .replace("__TITLE__", title)
            .replace("__V__", _b64(inter))
            .replace("__F__", _b64(faces))
            .replace("__L__", _b64(seg))
            .replace("__P__", _b64(pts))
            .replace("__CENTER__", repr([round(c, 6) for c in center]))
            .replace("__RADIUS__", repr(round(radius, 6))))
    with open(path, "w") as f:
        f.write(html)
    return path
