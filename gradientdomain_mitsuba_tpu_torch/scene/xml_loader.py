"""Mitsuba XML scene parser.

TPU-native replacement for Mitsuba's SceneHandler (Xerces SAX parser,
src/librender/scenehandler.cpp).  Parses unmodified Mitsuba 0.5 scene files:
plugin elements with typed property children, <transform> stacks, <default>
+ $var substitution (overridable from the CLI via -D, matching
src/mitsuba/mitsuba.cpp), <ref id>, <include>, and sRGB/spectrum values.
"""
from __future__ import annotations

import os
import re
import xml.etree.ElementTree as ET
from typing import Dict, Optional

import numpy as np

from ..core import math as m
from .ir import Plugin, SceneDesc

_PLUGIN_TAGS = {
    "scene", "integrator", "sensor", "sampler", "film", "rfilter", "shape",
    "bsdf", "emitter", "texture", "medium", "phase", "volume", "subsurface",
}
_PROP_TAGS = {
    "integer", "float", "boolean", "string", "spectrum", "rgb", "srgb",
    "point", "vector", "transform", "ref", "default", "alias", "include",
    "translate", "rotate", "scale", "matrix", "lookat", "lookAt", "animation",
}

_VAR_RE = re.compile(r"\$(\w+)")


class SceneParseError(RuntimeError):
    pass


def _substitute(text: str, variables: Dict[str, str]) -> str:
    def repl(mm):
        name = mm.group(1)
        if name not in variables:
            raise SceneParseError(
                f'undefined scene parameter "${name}" (pass -D {name}=...)')
        return variables[name]
    return _VAR_RE.sub(repl, text)


def _parse_floats(s: str) -> np.ndarray:
    return np.array([float(x) for x in re.split(r"[,\s]+", s.strip()) if x],
                    np.float64)


def _srgb_to_linear(c):
    c = np.asarray(c, np.float64)
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def _parse_spectrum(value: str, intent_srgb: bool) -> np.ndarray:
    """spectrum/rgb/srgb value -> linear RGB triple.

    Handles uniform values, triples, hex colors (#rrggbb for srgb), and
    wavelength:value lists (converted crudely via uniform average — full
    spectral upsampling is out of scope; Mitsuba default build is RGB too).
    """
    value = value.strip()
    if value.startswith("#"):
        v = np.array([int(value[i:i + 2], 16) / 255.0 for i in (1, 3, 5)])
        return _srgb_to_linear(v).astype(np.float32)
    if ":" in value:
        pairs = [p for p in re.split(r"[,\s]+", value) if p]
        vals = np.array([float(p.split(":")[1]) for p in pairs])
        return np.full(3, vals.mean(), np.float32)
    a = _parse_floats(value)
    if a.size == 1:
        a = np.full(3, a[0])
    if intent_srgb:
        a = _srgb_to_linear(a)
    return a.astype(np.float32)


def _parse_transform(elem, variables) -> np.ndarray:
    """Accumulate a 4x4 toWorld matrix. Mitsuba applies child elements in
    document order, each PRE-multiplying the accumulated transform
    (m = child * m), so the first listed op is applied to points first."""
    mat = np.eye(4)
    for ch in elem:
        tag = ch.tag
        g = lambda k, d=None: (_substitute(ch.get(k), variables)
                               if ch.get(k) is not None else d)
        if tag == "translate":
            v = [float(g("x", "0")), float(g("y", "0")), float(g("z", "0"))]
            mat = m.np_translate(v) @ mat
        elif tag == "scale":
            if g("value") is not None:
                s = _parse_floats(g("value"))
                v = [s[0]] * 3 if s.size == 1 else list(s)
            else:
                v = [float(g("x", "1")), float(g("y", "1")), float(g("z", "1"))]
            mat = m.np_scale(v) @ mat
        elif tag == "rotate":
            axis = [float(g("x", "0")), float(g("y", "0")), float(g("z", "0"))]
            mat = m.np_rotate(axis, float(g("angle", "0"))) @ mat
        elif tag == "matrix":
            vals = _parse_floats(g("value"))
            mm2 = vals.reshape(4, 4) if vals.size == 16 else _mat3_to_4(vals)
            mat = mm2 @ mat
        elif tag in ("lookat", "lookAt"):
            origin = _parse_floats(g("origin"))
            target = _parse_floats(g("target"))
            up = _parse_floats(g("up", "0 1 0"))
            mat = m.np_look_at(origin, target, up) @ mat
        else:
            raise SceneParseError(f"unknown transform op <{tag}>")
    return mat


def _mat3_to_4(vals):
    mm2 = np.eye(4)
    mm2[:3, :3] = vals.reshape(3, 3)
    return mm2


def _parse_plugin(elem, variables, base_dir, id_map) -> Plugin:
    ptype = elem.get("type")
    if ptype is not None:
        ptype = _substitute(ptype, variables)
    node = Plugin(kind=elem.tag, type=ptype or "", id=elem.get("id"))
    if node.id:
        id_map[node.id] = node

    for ch in elem:
        tag = ch.tag
        if tag == "default":
            name = ch.get("name")
            if name not in variables:
                variables[name] = _substitute(ch.get("value"), variables)
            continue
        if tag == "include":
            fname = _substitute(ch.get("filename"), variables)
            sub = load(os.path.join(base_dir, fname), dict(variables))
            node.children.extend(
                ([sub.integrator] if sub.integrator else []) +
                ([sub.sensor] if sub.sensor else []) +
                sub.shapes + sub.emitters + sub.media)
            continue
        if tag == "alias":
            if ch.get("id") in id_map:
                id_map[ch.get("as")] = id_map[ch.get("id")]
            continue
        if tag == "ref":
            rid = _substitute(ch.get("id"), variables)
            if rid not in id_map:
                raise SceneParseError(f'<ref id="{rid}"> to unknown object')
            target = id_map[rid]
            name = ch.get("name")
            if name:
                node.props[name] = target
            else:
                node.children.append(target)
            continue
        name = ch.get("name")
        if tag in _PLUGIN_TAGS:
            child = _parse_plugin(ch, variables, base_dir, id_map)
            if name:
                node.props[name] = child
            else:
                node.children.append(child)
            continue
        if tag == "animation":
            # animated transforms: take the first keyframe (no motion blur)
            for tr in ch:
                if tr.tag == "transform":
                    node.props[ch.get("name", "toWorld")] = _parse_transform(
                        tr, variables)
                    break
            continue
        if tag not in _PROP_TAGS:
            raise SceneParseError(f"unknown element <{tag}>")
        if tag == "transform":
            node.props[name or "toWorld"] = _parse_transform(ch, variables)
            continue
        value = ch.get("value")
        if value is not None:
            value = _substitute(value, variables)
        if tag == "integer":
            node.props[name] = int(value)
        elif tag == "float":
            node.props[name] = float(value)
        elif tag == "boolean":
            node.props[name] = value.strip().lower() == "true"
        elif tag == "string":
            node.props[name] = value
        elif tag in ("spectrum", "rgb", "srgb"):
            if value is None and ch.get("filename") is not None:
                # spectrum from .spd file: average it into RGB (RGB build)
                node.props[name] = _load_spd(
                    os.path.join(base_dir, _substitute(ch.get("filename"),
                                                       variables)))
            else:
                node.props[name] = _parse_spectrum(value, tag == "srgb")
        elif tag == "point":
            if value is not None:
                node.props[name] = _parse_floats(value).astype(np.float32)
            else:
                node.props[name] = np.array(
                    [float(_substitute(ch.get(k, "0"), variables))
                     for k in "xyz"], np.float32)
        elif tag == "vector":
            if value is not None:
                node.props[name] = _parse_floats(value).astype(np.float32)
            else:
                node.props[name] = np.array(
                    [float(_substitute(ch.get(k, "0"), variables))
                     for k in "xyz"], np.float32)
    return node


def _load_spd(path) -> np.ndarray:
    vals = []
    with open(path) as f:
        for line in f:
            line = line.split("#")[0].strip()
            if not line:
                continue
            _, v = line.split()[:2]
            vals.append(float(v))
    return np.full(3, float(np.mean(vals)), np.float32)


def load(path: str, variables: Optional[Dict[str, str]] = None) -> SceneDesc:
    """Parse a Mitsuba scene XML file into a SceneDesc."""
    variables = dict(variables or {})
    base_dir = os.path.dirname(os.path.abspath(path))
    tree = ET.parse(path)
    root = tree.getroot()
    if root.tag != "scene":
        raise SceneParseError(f"root element is <{root.tag}>, expected <scene>")
    id_map: Dict[str, Plugin] = {}
    scene_node = _parse_plugin(root, variables, base_dir, id_map)

    integrator = sensor = None
    shapes, emitters, media = [], [], []
    for c in scene_node.children:
        if c.kind == "integrator":
            integrator = c
        elif c.kind == "sensor":
            sensor = c
        elif c.kind == "shape":
            shapes.append(c)
        elif c.kind == "emitter":
            emitters.append(c)
        elif c.kind == "medium":
            media.append(c)
        elif c.kind in ("bsdf", "texture"):
            pass  # top-level definitions referenced via <ref>
        else:
            raise SceneParseError(f"unexpected scene child <{c.kind}>")
    return SceneDesc(
        integrator=integrator, sensor=sensor, shapes=shapes,
        emitters=emitters, media=media, base_dir=base_dir,
        version=root.get("version", "0.5.0"))
