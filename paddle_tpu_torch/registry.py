"""Op registry (parity: framework/op_registry.h:68 REGISTER_OPERATOR /
op_info.h OpInfoMap).

Each op type registers ONE rule: a plain function from (``torch.Tensor``s in,
attrs) to tensors out, run eagerly by the executor on whatever device the
tensors lie on.  A copy of the JAX package's ``registry.py``; the port
registers only the rules its slices need so far (``ops/``), and any other
op type raises the "no lowering registered" error below.
"""

_OP_LOWERING = {}


class OpLoweringContext:
    """Passed to rules that need program context: the program, the run's
    random generator (whose device is the one the run's tensors lie on),
    and, for control flow, ``interpret_block(block_idx, env) -> env``, which
    runs a sub-block's ops on a copy of ``env``.  The executor sets ``env``
    to the block's whole name -> tensor map before each rule, so that the
    control-flow rules read carried and closure vars by name."""

    def __init__(self, program, generator, axis_env=None):
        self.program = program
        # ring_id -> mesh axis name for the collective ops; empty (every
        # collective an identity) unless a caller running the program
        # inside a mesh passes it, as in the reference
        self.axis_env = axis_env or {}
        # seeded per run (program.random_seed, step); random ops derive
        # their own generator from it and their seed attr (ops/common.py)
        self.generator = generator
        self.interpret_block = None     # set by the executor's plan
        self.env = None
        # a data-parallel run's state (parallel/batch_axes.py Run), or None
        self.dp = None
        # a tensor-parallel run's (parallel/model_axes.py Run), or None
        self.tp = None

    @property
    def device(self):
        return self.generator.device


def register_op(type_name):
    """Decorator: register a lowering rule.

    Rule signature: fn(ins: dict[slot, list[torch.Tensor]], attrs: dict,
                       ctx: OpLoweringContext) -> dict[slot, list[torch.Tensor]]
    """

    def deco(fn):
        if type_name in _OP_LOWERING:
            raise ValueError("op %r registered twice" % type_name)
        _OP_LOWERING[type_name] = fn
        return fn

    return deco


def get_lowering(type_name):
    fn = _OP_LOWERING.get(type_name)
    if fn is None:
        raise NotImplementedError(
            "no lowering registered for op type %r (registered: %d ops)"
            % (type_name, len(_OP_LOWERING))
        )
    return fn


def registered_ops():
    return sorted(_OP_LOWERING.keys())


def is_registered(type_name):
    return type_name in _OP_LOWERING
