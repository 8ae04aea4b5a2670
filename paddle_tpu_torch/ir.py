"""Program-pass framework (counterpart of ``paddle_tpu/ir.py``; parity:
framework/ir — ir::Pass subclasses, PassRegistry / pass_builder).

The reference's fuse and placement passes rewrite an ir::Graph for its
kernels; the port's executor runs a program op by op, so what stays at the
framework level is the pass machinery: named, registered, composable
Program -> Program rewrites (quantization freeze and convert, pruning
masks, distillation merges).  ``Pass`` (apply(program) -> program), a
registry and ``PassManager`` pipelines, so that
``apply_pass(program, name, ...)`` works as ``pass_builder->AppendPass``
does in the reference.  The slim passes registered by name below wait for
``contrib.slim`` (ROADMAP Queue 1 item 3-D) and raise until it lands.
"""

__all__ = ["Pass", "register_pass", "get_pass", "registered_passes",
           "apply_pass", "PassManager"]

_PASSES = {}


class Pass:
    """Parity: ir::Pass — a named Program rewrite.  Subclasses implement
    apply(program) -> program (in place or a new Program)."""

    name = None

    def apply(self, program):
        raise NotImplementedError

    def __call__(self, program):
        return self.apply(program)


def register_pass(name):
    """Decorator (parity: REGISTER_PASS): registers a Pass subclass or a
    factory returning one under ``name``."""

    def deco(cls_or_factory):
        _PASSES[name] = cls_or_factory
        if isinstance(cls_or_factory, type) and issubclass(cls_or_factory,
                                                           Pass):
            cls_or_factory.name = name
        return cls_or_factory

    return deco


def get_pass(name, *args, **kwargs):
    """Instantiate a registered pass (parity: PassRegistry::Get)."""
    if name not in _PASSES:
        raise KeyError("no pass registered under %r (have: %s)"
                       % (name, ", ".join(sorted(_PASSES))))
    return _PASSES[name](*args, **kwargs)


def registered_passes():
    return sorted(_PASSES)


def apply_pass(program, name, *args, **kwargs):
    return get_pass(name, *args, **kwargs).apply(program)


class PassManager:
    """Parity: the pass_builder pipeline (paddle_pass_builder.cc): an
    ordered list of pass instances applied in sequence."""

    def __init__(self, passes=()):
        self.passes = list(passes)

    def append(self, pass_or_name, *args, **kwargs):
        p = (pass_or_name if isinstance(pass_or_name, Pass)
             else get_pass(pass_or_name, *args, **kwargs))
        self.passes.append(p)
        return self

    def apply(self, program):
        for p in self.passes:
            program = p.apply(program)
        return program


# -- the slim transforms, registered by name --------------------------------

def _slim_pass(name):
    def factory(*args, **kwargs):
        raise NotImplementedError(
            "%s: contrib.slim's quantization passes wait (ROADMAP Queue 1 "
            "item 3-D)" % name)
    register_pass(name)(factory)


for _name in ("quantization_transform_pass", "quantization_freeze_pass",
              "convert_to_int8_pass", "transform_for_mobile_pass"):
    _slim_pass(_name)
