#!/usr/bin/env python3
"""Blender scene exporter: the port's copy of
`humanrf_tpu/toolbox/export_blender.py`, reading cameras through the port's
`core/camera` (same CLI; runs inside Blender):

    blender --background --python export_blender.py -- \
        --csv /path/to/calibration.csv --blend /tmp/cameras.blend \
        [--images <rgbs_dir>] [--obj mesh.obj | --abc meshes.abc | --scale S] \
        [--image_name "{camera_name}_rgb000000.jpg"] [--no_root]

What it builds:
- two render scenes (landscape / portrait — the rig mixes orientations) with
  EEVEE + multiview render settings and compositor file-output nodes for
  depth (EXR), normal (EXR) and mask (PNG) passes;
- one pinhole camera per calibrated camera (sensor-relative principal-point
  shift, mm lens from the normalized focal length), each with its own render
  view, optionally with the frame's rgb as a background image stored with a
  blend-relative path;
- an optional root empty that rescales the scene and rotates it Z-up;
- the person mesh, either a wavefront obj or an alembic animation attached
  through a MESH_SEQUENCE_CACHE modifier.

bpy only exists inside Blender; importing this module elsewhere prints usage
and exits cleanly.
"""

try:
    import bpy
except ModuleNotFoundError:
    import sys

    print(
        "This program needs to be executed through blender like this:\n"
        "```\nblender --background --python export_blender.py -- "
        "--csv /path/to/calibration.csv --blend /tmp/cameras.blend\n```"
    )
    sys.exit(0)

import argparse
import math
import os
import sys
from pathlib import Path

import numpy as np
from bpy_extras.image_utils import load_image
from mathutils import Matrix, Vector

sys.path.append(str(Path(__file__).resolve().parent.parent.parent))
from humanrf_torch.core.camera import CameraData, read_calibration_csv  # noqa: E402

_PASS_NODES = (
    # (node name, render-layer output, color mode, format, directory)
    ("Depth Output", "Depth", "RGB", "OPEN_EXR", "//depth"),
    ("Normal Output", "Normal", "RGB", "OPEN_EXR", "//normal"),
    ("Mask Output", "Alpha", "BW", "PNG", "//mask"),
)


def _setup_render_scene(name: str, resolution_x: int, resolution_y: int):
    """A render-ready scene: EEVEE, multiview, transparent film, and muted
    compositor file-output nodes for the depth/normal/mask passes."""
    scene = bpy.data.scenes.new(name)
    render = scene.render
    render.engine = "BLENDER_EEVEE"
    render.filepath = "//rgb/"
    render.image_settings.file_format = "PNG"
    render.image_settings.color_mode = "RGBA"
    render.resolution_x = resolution_x
    render.resolution_y = resolution_y
    render.resolution_percentage = 100
    render.pixel_aspect_x = render.pixel_aspect_y = 1
    render.dither_intensity = 0.0
    render.film_transparent = True
    render.use_multiview = True
    render.views_format = "MULTIVIEW"
    for stereo_view in ("left", "right"):
        if stereo_view in render.views:
            render.views[stereo_view].use = False
    scene.frame_start = scene.frame_end = 1

    scene.use_nodes = True
    view_layer = scene.view_layers[0]
    view_layer.use_pass_z = True
    view_layer.use_pass_normal = True
    view_layer.use_pass_object_index = True
    render_layers = scene.node_tree.nodes.get("Render Layers")
    for i, (node_name, source, color_mode, file_format, base_path) in enumerate(_PASS_NODES):
        node = scene.node_tree.nodes.new(type="CompositorNodeOutputFile")
        node.name = node_name
        node.format.color_mode = color_mode
        node.format.file_format = file_format
        node.base_path = base_path
        node.location = Vector((300, 250 - 150 * i))
        node.mute = True  # enabled by the user when the pass is wanted
        scene.node_tree.links.new(render_layers.outputs[source], node.inputs["Image"])
    return scene


def _make_root(scale: float):
    """Empty that rescales the scene and rotates it Z-up (+90° about X)."""
    root = bpy.data.objects.new("root", None)
    root.empty_display_type = "PLAIN_AXES"
    root.scale = Vector((scale, scale, scale))
    root.rotation_euler = Vector((0.5 * math.pi, 0, 0))
    root.empty_display_size = 1 / scale  # renders as 1m after scaling
    return root


def _make_pinhole_camera(camera: CameraData, scale: float):
    """Blender camera matching our RDF pinhole: mm lens on a 36mm sensor,
    sensor-relative principal-point shift, 180°-about-X axis conversion."""
    if not np.isclose(camera.fx_pixel, camera.fy_pixel):
        raise RuntimeError(f"{camera.name}: non-square pixels (downscaled images?)")

    data = bpy.data.cameras.new(f"camd_{camera.name}")
    data.sensor_fit = "HORIZONTAL"
    data.type = "PERSP"
    data.lens_unit = "MILLIMETERS"
    data.sensor_width = 36
    data.lens = float(camera.focal_length[0]) * data.sensor_width
    data.shift_x = -(float(camera.principal_point[0]) - 0.5)
    data.shift_y = (float(camera.principal_point[1]) - 0.5) * camera.height / camera.width
    data.display_size = 0.1 / scale

    obj = bpy.data.objects.new(f"cam_{camera.name}", data)
    obj.location = Vector(camera.translation)
    angle = float(np.linalg.norm(camera.rotation_axisangle))
    axis = camera.rotation_axisangle / angle
    # RDF (+z forward, +y down) → Blender (−z forward, +y up): 180° about X.
    rotation = Matrix.Rotation(angle, 4, Vector(axis)) @ Matrix.Rotation(math.pi, 4, "X")
    obj.rotation_mode = "QUATERNION"
    obj.rotation_quaternion = rotation.to_quaternion()
    return obj


def _attach_background_image(cam_obj, camera: CameraData, images_dir: Path, image_name: str, blend_path: Path):
    cam_obj.data.show_background_images = True
    filename = image_name.format(camera_name=camera.name)
    image = load_image(filename, images_dir / camera.name, recursive=False, place_holder=True)
    background = cam_obj.data.background_images.new()
    background.image = image
    # Blend-relative path so the .blend stays portable.
    rel = os.path.relpath(images_dir / camera.name / filename, Path(blend_path).resolve().parent)
    image.filepath_raw = f"//{rel}"


def _import_person_obj(path: Path):
    import_op = getattr(bpy.ops.wm, "obj_import", None) or bpy.ops.import_scene.obj
    import_op(filepath=str(path))
    person = bpy.context.selected_objects[0]
    person.name = "person"
    person.rotation_euler = Vector((0, 0, 0))
    return person


def _import_person_abc(path: Path, object_path: str):
    """Animated alembic person via a mesh-sequence-cache modifier."""
    mesh = bpy.data.meshes.new("person")
    person = bpy.data.objects.new("person", mesh)
    person.rotation_euler = (-math.pi / 2, 0, 0)
    bpy.ops.cachefile.open(filepath=str(path))
    modifier = person.modifiers.new("sequence_cache", "MESH_SEQUENCE_CACHE")
    modifier.cache_file = bpy.data.cache_files[0]
    modifier.object_path = object_path
    modifier.use_vertex_interpolation = False
    return person


def main():
    argv = sys.argv[sys.argv.index("--") + 1 :] if "--" in sys.argv else []
    parser = argparse.ArgumentParser(description="Export calibrated cameras (+ person mesh) to a .blend")
    parser.add_argument("--csv", type=Path, required=True, help="calibration.csv")
    parser.add_argument("--blend", type=Path, required=True, help="Output .blend path")
    parser.add_argument("--images", type=Path, help="rgbs directory for camera background images")
    parser.add_argument("--image_name", type=str, default="{camera_name}_rgb000000.jpg")
    parser.add_argument("--no_root", action="store_true", help="Skip the meters/Z-up root transform")
    mesh_group = parser.add_mutually_exclusive_group()
    mesh_group.add_argument("--obj", type=Path, help="Person mesh (wavefront)")
    mesh_group.add_argument("--abc", type=Path, help="Person mesh animation (alembic)")
    parser.add_argument("--abc_object_path", default="/object")
    parser.add_argument("--scale", type=float, default=1.0, help="Scene scale factor")
    args = parser.parse_args(argv)

    bpy.ops.wm.read_homefile(use_empty=True)
    # Save immediately so later paths can be blend-relative.
    args.blend.parent.mkdir(parents=True, exist_ok=True)
    bpy.ops.wm.save_as_mainfile(filepath=os.fspath(args.blend))

    cameras = read_calibration_csv(args.csv)
    short_edge = min(cameras[0].width, cameras[0].height)
    long_edge = max(cameras[0].width, cameras[0].height)

    default_scene = bpy.data.scenes[0]
    scenes = {
        "landscape": _setup_render_scene("landscape", long_edge, short_edge),
        "portrait": _setup_render_scene("portrait", short_edge, long_edge),
    }
    bpy.data.scenes.remove(default_scene)

    collections = {}
    for orientation, scene in scenes.items():
        collections[orientation] = bpy.data.collections.new(f"cameras_{orientation}")
        scene.collection.children.link(collections[orientation])

    root = None
    if not args.no_root:
        root = _make_root(args.scale)
        for collection in collections.values():
            collection.objects.link(root)

    for camera in cameras:
        orientation = "landscape" if camera.width > camera.height else "portrait"
        scene = scenes[orientation]
        cam_obj = _make_pinhole_camera(camera, args.scale)
        collections[orientation].objects.link(cam_obj)
        if root is not None:
            cam_obj.parent = root
        scene.camera = cam_obj
        if f"renderview_{camera.name}" not in scene.render.views:
            view = scene.render.views.new(f"renderview_{camera.name}")
            view.camera_suffix = f"_{camera.name}"
        if args.images:
            _attach_background_image(cam_obj, camera, args.images, args.image_name, args.blend)

    person = None
    if args.obj:
        person = _import_person_obj(args.obj)
    elif args.abc:
        person = _import_person_abc(args.abc, args.abc_object_path)
    if person is not None:
        if root is not None:
            person.parent = root
        for scene in scenes.values():
            if person.name not in scene.collection.objects:
                scene.collection.objects.link(person)

    bpy.ops.wm.save_as_mainfile(filepath=os.fspath(args.blend))
    print(f"Wrote {args.blend}")


if __name__ == "__main__":
    main()
