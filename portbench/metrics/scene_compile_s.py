"""Host seconds of the program's `scene.compile` span (materials, textures,
geometry, lights, the accelerator's build): the program window compiles the
cell's scene once more, warm, with the program's tracing on."""
from portbench import program_trace


def read(ctx):
    prog = program_trace.read(ctx)
    return None if prog is None else prog.compile_s
