"""G_roofline.render.f32: `G_roofline.render` in the float32 sweep cells, a metric of its own
because it moves `render_rays_per_s.f32`, their rate."""
from benchmark.harness.cell import BENCH, load_module

read = load_module(BENCH / "metrics" / "G_roofline.render.py").read
