"""The port's front ends: the example runners and the Gradio apps' callbacks."""
