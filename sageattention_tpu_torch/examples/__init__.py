"""The command-line examples of the port, one module each (the JAX
package's ``examples/``): ``python -m sageattention_tpu_torch.examples.<name>``.
Each module's ``main(argv=None)`` parses its flags, runs, prints its report
and returns it as a dict, so that it can also be called in-process."""
