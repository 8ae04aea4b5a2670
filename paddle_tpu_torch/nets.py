"""Composite networks (parity: python/paddle/fluid/nets.py —
simple_img_conv_pool, img_conv_group, sequence_conv_pool, glu,
scaled_dot_product_attention).  A copy of the JAX package's ``nets.py``."""

from . import layers

__all__ = ["sequence_conv_pool", "simple_img_conv_pool", "img_conv_group", "glu",
           "scaled_dot_product_attention"]


def simple_img_conv_pool(
    input, num_filters, filter_size, pool_size, pool_stride, pool_padding=0,
    pool_type="max", global_pooling=False, conv_stride=1, conv_padding=0,
    conv_dilation=1, conv_groups=1, param_attr=None, bias_attr=None, act=None,
    use_cudnn=True,
):
    conv_out = layers.conv2d(
        input=input, num_filters=num_filters, filter_size=filter_size,
        stride=conv_stride, padding=conv_padding, dilation=conv_dilation,
        groups=conv_groups, param_attr=param_attr, bias_attr=bias_attr, act=act,
    )
    return layers.pool2d(
        input=conv_out, pool_size=pool_size, pool_type=pool_type,
        pool_stride=pool_stride, pool_padding=pool_padding,
        global_pooling=global_pooling,
    )


def img_conv_group(
    input, conv_num_filter, pool_size, conv_padding=1, conv_filter_size=3,
    conv_act=None, param_attr=None, conv_with_batchnorm=False,
    conv_batchnorm_drop_rate=0.0, pool_stride=1, pool_type="max", use_cudnn=True,
):
    tmp = input
    if not isinstance(conv_num_filter, (list, tuple)):
        conv_num_filter = [conv_num_filter]
    for i, nf in enumerate(conv_num_filter):
        local_act = None if conv_with_batchnorm else conv_act
        tmp = layers.conv2d(
            input=tmp, num_filters=nf, filter_size=conv_filter_size,
            padding=conv_padding, param_attr=param_attr, act=local_act,
        )
        if conv_with_batchnorm:
            tmp = layers.batch_norm(input=tmp, act=conv_act)
            rate = conv_batchnorm_drop_rate
            if isinstance(rate, (list, tuple)):
                rate = rate[i]
            if rate > 0:
                tmp = layers.dropout(x=tmp, dropout_prob=rate)
    return layers.pool2d(input=tmp, pool_size=pool_size, pool_type=pool_type,
                         pool_stride=pool_stride)


def glu(input, dim=-1):
    a, b = layers.split(input, num_or_sections=2, dim=dim)
    return layers.elementwise_mul(a, layers.sigmoid(b))


def scaled_dot_product_attention(queries, keys, values, num_heads=1, dropout_rate=0.0):
    """Parity: nets.py scaled_dot_product_attention — composed attention."""
    d = queries.shape[-1]
    scores = layers.matmul(queries, keys, transpose_y=True, alpha=float(d) ** -0.5)
    weights = layers.softmax(scores)
    if dropout_rate:
        weights = layers.dropout(weights, dropout_prob=dropout_rate)
    return layers.matmul(weights, values)


def sequence_conv_pool(input, num_filters, filter_size, param_attr=None,
                       act="sigmoid", pool_type="max", bias_attr=None,
                       seq_len=None):
    """Parity: nets.py sequence_conv_pool — sequence_conv + sequence_pool
    over the padded [N, T, D] representation (pass seq_len to mask tails)."""
    from .layers.extras import sequence_conv
    from .layers.sequence import sequence_pool

    conv_out = sequence_conv(input, num_filters=num_filters,
                             filter_size=filter_size, param_attr=param_attr,
                             bias_attr=bias_attr, act=act, seq_len=seq_len)
    return sequence_pool(conv_out, pool_type, seq_len=seq_len)
