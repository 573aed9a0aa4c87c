"""The system under test, built from a configuration through the program's
public entry points: ``scene.factories.SceneBuilder`` for the scene,
``render.texture.TextureSet`` and ``with_mips`` for the textures,
``render.trace.RenderConfig`` for the settings, ``apps.demo.update_scene``
for the animation's pose (where the configuration has handles).  This is
the only module of the harness that builds program objects; the traffic
loops drive them.
"""

from __future__ import annotations

from rtbench import scenedata


def imports():
    """Import the program's modules that the harness drives."""
    import txr_torch.apps.demo  # noqa: F401
    import txr_torch.render.render  # noqa: F401
    import txr_torch.render.texture  # noqa: F401
    import txr_torch.scene.factories  # noqa: F401


def scene(cfg, dev):
    """(the program's scene on ``dev``, the demo's animation handles, or
    None where the configuration names none)."""
    from txr_torch.apps.demo import DemoHandles
    from txr_torch.scene.factories import SceneBuilder

    rows = scenedata.scene_rows(cfg)
    sc = cfg["scene"]
    t = lambda v: tuple(float(x) for x in v)
    b = SceneBuilder(camera_pos=t(rows["camera"]["pos"]), camera_quat=t(rows["camera"]["quat"]))
    b.ambient_color = t(rows["ambient_color"])
    b.shadow_ambient = t(rows["shadow_ambient"])
    b.bg_color = t(rows["bg_color"])
    for l in rows["lights_point"]:
        b.add_light_point(t(l["pos"]), t(l["color"]), float(l["intensity"]),
                          radius=float(l["radius"]), linear_k=float(l["linear_k"]),
                          quadratic_k=float(l["quadratic_k"]))
    for l in rows["lights_direct"]:
        b.add_light_direct(t(l["direction"]), t(l["color"]), float(l["intensity"]))

    def mat(m):
        return b.material(t(m["color"]), specular=float(m["specular"]),
                          reflect=float(m["reflect"]), refract=float(m["refract"]),
                          absorb=t(m["absorb"]), diffuse=float(m["diffuse"]),
                          kd=float(m["kd"]), ks=float(m["ks"]))

    for r in rows["spheres"]:
        b.add_sphere(t(r["pos"]), float(r["radius"]), mat(r["mat"]), hollow=r["hollow"],
                     texture=r["texture"], quat=t(r["quat"]))
    for r in rows["planes"]:
        b.add_plane(t(r["normal"]), t(r["pos"]), mat(r["mat"]))
    for r, given in zip(rows["rings"], sc.get("rings", [])):
        b.add_ring(t(r["pos"]), float(given["r1"]), float(given["r2"]), mat(r["mat"]),
                   texture=r["texture"], quat=t(r["quat"]))
    for r in rows["boxes"]:
        b.add_box(t(r["pos"]), t(r["form"]), mat(r["mat"]), texture=r["texture"],
                  quat=t(r["quat"]))
    for r in rows["toruses"]:
        b.add_torus(t(r["pos"]), t(r["form"]), mat(r["mat"]), quat=t(r["quat"]))
    for r in rows["surfaces"]:
        b.add_surface(t(r["coef"]), mat(r["mat"]), pos=t(r["pos"]), quat=t(r["quat"]),
                      v_min=t(r["v_min"]), v_max=t(r["v_max"]))
    handles = cfg.get("handles")
    if handles is not None:
        handles = DemoHandles(**{k: scenedata.index_of(rows, kind, name)
                                 for k, (kind, name) in handles.items()})
    return b.build().to(dev), handles


def textures(cfg, raw):
    """The program's texture set of the raw textures, its atlas and mip
    pyramids built (``with_mips``, set-up's glGenerateMipmap), of the roles
    the configuration names (none, if it has no ``textures``)."""
    from txr_torch.render.texture import TextureSet, with_mips

    names = cfg.get("textures", {})
    role = lambda r: raw[names[r]] if names.get(r) else None
    return with_mips(TextureSet(sphere=tuple(raw[n] for n in names.get("sphere", ())),
                                ring=role("ring"), box=role("box"), cubemap=role("cubemap")))


def render_config(cfg, width=None, height=None):
    """The program's RenderConfig of the configuration (at another size if
    given)."""
    from txr_torch.render.trace import RenderConfig

    r = cfg["render"]
    rc = RenderConfig(width=width or r["width"], height=height or r["height"],
                      iterations=r["iterations"], extra_refraction_steps=r["extra_refraction_steps"],
                      fused=r["fused"], texture_lod=r["texture_lod"],
                      edge_threshold=r["edge_threshold"], edge_budget_mult=r["edge_budget_mult"])
    return rc.with_aa_preset(r["aa_preset"]) if r.get("aa_preset") else rc


def pose(scene, handles, t):
    """The scene at the animation's time ``t`` seconds (no spin: dt = 0),
    as the live viewer poses each frame (``apps/live.py``); without
    handles, the scene as it is (no program call)."""
    from txr_torch.apps.demo import update_scene

    if handles is None:
        return scene
    return update_scene(scene, handles, 0.0, t)
